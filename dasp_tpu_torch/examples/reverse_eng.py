"""Reverse-engineer an effect parameter by gradient descent (script form):
runs the quickstart recipe (see :mod:`dasp_tpu_torch.examples.quickstart`).

    python -m dasp_tpu_torch.examples.reverse_eng [--drive-db 16]
"""

from .quickstart import main

if __name__ == "__main__":
    main()
