"""observables_device_ms_per_sample (program span): device milliseconds of
the program's ``ising.observables`` spans (the merge, the float64
magnetization and energy of one sample, between a pair of CUDA events) in
the traced window, over the window's samples."""

from perfbench import spans


def read(run):
    n_samples = spans.params(run).get("n_samples")
    got = spans.device_ms(run, "ising.observables")
    if not n_samples or got is None:
        return None
    return got[1] / (run.calls * n_samples)
