"""host_syncs_per_sample (program counter): the program's ``host_syncs``
counter, the points where the host waits for the card (reads of device
tensors, copies in from pageable memory), in the traced window over the
window's samples."""

from perfbench import spans


def read(run):
    n_samples = spans.params(run).get("n_samples")
    syncs = spans.counter(run, "host_syncs")
    if not n_samples or syncs is None:
        return None
    return syncs / (run.calls * n_samples)
