"""The tools a traffic file can name, one file each:
`prepare(workload, config, traffic, device, out_dir) -> call`, where
`call()` runs the tool once on the workload through the port and returns
the paths of its output files.  The only files that import the port."""
