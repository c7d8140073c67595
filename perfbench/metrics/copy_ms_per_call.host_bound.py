"""copy_ms_per_call.host_bound: copy_ms_per_call in the host-bound cells, read as there; it
moves site_updates_per_s.host_bound, the rate of the cells whose calls
the host's launch path bounds."""

from perfbench.run import HERE, load_module

read = load_module(HERE / "metrics" / "copy_ms_per_call.py").read
