"""Share of the window rows the offline pass computes that hold audio: the
real windows over the bucket's rows (window count rounded up to a power of
two), summed over the program's `diar.request` spans
(`fluidaudio_tpu_torch.utils.profiling`, recorded in the profiled
sub-window), in %."""


def read(run):
    try:
        from fluidaudio_tpu_torch.utils.profiling import summary
    except ImportError:  # a program without spans
        return None
    counts = summary().get("diar.request", {}).get("counts", {})
    if not counts.get("bucket_rows"):
        return None
    return 100.0 * counts["windows"] / counts["bucket_rows"]
