"""site_updates_per_s.host_bound (host clock): site_updates_per_s in the
cells whose calls the host's launch path bounds. Their rate follows the
speed of the host's CPU, which varies from run to run on a shared host, so
it is held to a bound of its own."""

from perfbench.run import HERE, load_module

read = load_module(HERE / "metrics" / "site_updates_per_s.py").read
