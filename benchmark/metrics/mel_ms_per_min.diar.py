"""Device ms of the mel frontend (CUDA events around the call, synced at
each boundary) per minute of audio in the timed part of a traced window."""


def read(run):
    t = run.device.get("mel")
    return t * 1e3 / (run.part_audio_s / 60) if t and run.part_audio_s else None
