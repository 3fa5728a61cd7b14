"""Traffic generators: each module reads the parameters of a mix file
(``perfbench/traffic/<mix>.json``, its ``"generator"`` key names the
module) and makes a run's inputs from its seed."""
