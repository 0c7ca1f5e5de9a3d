"""See the package docstring of `fluidaudio_tpu_torch`."""
