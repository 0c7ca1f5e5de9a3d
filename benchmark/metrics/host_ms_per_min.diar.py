"""Host ms per minute of audio inside the diarizer's entry outside its device
span (request wall less the entry's CUDA-event span, synced at each
boundary): the window buffer, the copies' waits, stitching and segments."""


def read(run):
    wall, dev = run.host.get("request"), run.device.get("entry")
    if not wall or dev is None or not run.part_audio_s:
        return None
    return (wall - dev) * 1e3 / (run.part_audio_s / 60)
