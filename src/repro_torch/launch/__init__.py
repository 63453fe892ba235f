"""Launchers of the port: `python -m repro_torch.launch.serve` (graph
serving), `.train` (LM training on one rank), `.graph_job` (the analytic
web-scale superstep) and `.report` (its tables); `roofline` holds the
H100's rates and `mesh` the rank layouts."""
