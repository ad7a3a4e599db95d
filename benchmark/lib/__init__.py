"""Shared pieces of the harness: the manifest, files, spans and the trace."""
