"""Which CUDA kernels a call launches, read from torch.profiler, for the
``gpu`` tests of the port's kernels."""


def launched(fn, want: str, tries: int = 5) -> set:
    """The names of the CUDA kernels one call of fn launches (profiler).  A
    trace with no kernel named `want` is taken again, up to `tries` times:
    the profiler on the card sometimes drops a run's device events (once
    all but the split sum's)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = {e.key for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA}
        if any(want in n for n in names):
            break
    return names
