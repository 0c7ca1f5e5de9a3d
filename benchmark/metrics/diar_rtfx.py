"""Audio seconds diarized per second of the window: the recordings
completed inside it, over the time from its start to the last completion."""


def read(run):
    return run.audio_s / run.window_s if run.window_s > 0 else None
