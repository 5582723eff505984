"""Which CUDA kernels a call launches, read from torch.profiler, for the
``gpu`` tests of the port's kernels."""
import time


def launched(fn, want: str, tries: int = 8) -> set:
    """The names of the CUDA kernels one call of fn launches (profiler).  A
    trace with no kernel named `want` is taken again, up to `tries` times,
    each after a longer pause: the profiler on the card sometimes drops a
    run's device events (once all but the split sum's), on some machines
    for several traces in a row."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(tries):
        time.sleep(0.25 * attempt)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = {e.key for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA}
        if any(want in n for n in names):
            break
    return names
