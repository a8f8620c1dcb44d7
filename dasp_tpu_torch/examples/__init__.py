"""The example applications on the port: each module has ``main(argv=None)``
(``python -m dasp_tpu_torch.examples.<name> --help``), runs on the CUDA card
unless given ``--device cpu``, and keeps the flags, defaults and output
files of the JAX package's script of the same name in ``examples/``."""
