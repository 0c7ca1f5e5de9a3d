"""Process start to the first timed request: weights, audio pool, program
build, kernel builds on a first run, calibration and warm-up."""


def read(run):
    return run.setup_s
