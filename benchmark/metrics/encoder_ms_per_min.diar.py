"""Device ms of ConformerEncoder.forward (CUDA events around the call, synced
at each boundary) per minute of audio in the timed part of a traced window."""


def read(run):
    t = run.device.get("encoder")
    return t * 1e3 / (run.part_audio_s / 60) if t and run.part_audio_s else None
