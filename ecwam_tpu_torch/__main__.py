"""``python -m ecwam_tpu_torch``: the command line of :mod:`.cli.main`."""

import sys

from ecwam_tpu_torch.cli.main import main

if __name__ == "__main__":
    sys.exit(main())
