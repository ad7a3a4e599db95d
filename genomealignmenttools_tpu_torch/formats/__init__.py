"""Byte-exact host codecs for the on-disk formats that form the toolkit's API.

The on-disk formats (chain, net, axt, psl, bed, 2bit, chrom.sizes, blastz
score matrices, linearGap tables) are the real interface of the reference
toolkit; every engine here reads and writes them byte-identically to the C
implementations (see SURVEY.md section 1 "On-disk formats are the real API").
"""
