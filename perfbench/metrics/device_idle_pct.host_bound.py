"""device_idle_pct.host_bound: device_idle_pct in the host-bound cells, read as there; it
moves site_updates_per_s.host_bound, the rate of the cells whose calls
the host's launch path bounds."""

from perfbench.run import HERE, load_module

read = load_module(HERE / "metrics" / "device_idle_pct.py").read
