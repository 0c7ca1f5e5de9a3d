"""`python -m fluidaudio_tpu_torch.cli ...`: the command's return code is the
process's exit status (JAX's `__main__` drops it and exits 0)."""

import sys

from fluidaudio_tpu_torch.cli.main import main

if __name__ == "__main__":
    sys.exit(main())
