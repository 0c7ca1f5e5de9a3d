"""Host ms per minute of audio of the diarizer's own work: the host seconds
of the program's spans `diar.plan`, `diar.stitch` and `diar.segments`
(`fluidaudio_tpu_torch.utils.profiling`, recorded in the profiled
sub-window), over the audio its `diar.request` spans count. The card has
no queued work in them: the plan precedes the request's launches, and the
predictions were downloaded with a sync before stitching."""

NAMES = ("diar.plan", "diar.stitch", "diar.segments")


def read(run):
    try:
        from fluidaudio_tpu_torch.utils.profiling import summary
    except ImportError:  # a program without spans
        return None
    s = summary()
    audio_s = s.get("diar.request", {}).get("counts", {}).get("audio_s")
    parts = [s[n]["host_s"] for n in NAMES if n in s]
    if not audio_s or not parts:
        return None
    return sum(parts) * 1e3 / (audio_s / 60)
