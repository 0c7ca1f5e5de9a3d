"""Device ms per minute of audio of the mel frontend (the cast, the
window cut and `MelFrontend`): the CUDA-event seconds of
the program's `mel` spans (`fluidaudio_tpu_torch.utils.profiling`,
recorded in the profiled sub-window), over the audio its `diar.request`
spans count."""


def read(run):
    try:
        from fluidaudio_tpu_torch.utils.profiling import summary
    except ImportError:  # a program without spans
        return None
    s = summary()
    audio_s = s.get("diar.request", {}).get("counts", {}).get("audio_s")
    dev = s.get("mel", {}).get("device_s")
    if not audio_s or dev is None:
        return None
    return dev * 1e3 / (audio_s / 60)
