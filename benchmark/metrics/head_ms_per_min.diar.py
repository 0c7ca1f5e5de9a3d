"""Device ms of the diarizer's head per minute of audio: the entry's device
span (CUDA events) less its mel and encoder spans."""


def read(run):
    e, m, c = run.device.get("entry"), run.device.get("mel"), run.device.get("encoder")
    if e is None or m is None or c is None or not run.part_audio_s:
        return None
    return (e - m - c) * 1e3 / (run.part_audio_s / 60)
