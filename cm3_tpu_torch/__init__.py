"""cm3_tpu_torch: the PyTorch/CUDA port of ``cm3_tpu``.

The package mirrors the JAX package's layout and names (``core``,
``envs``, ``models``, ``algs``, ``ops``, ``replay``, ``train``).  It
imports ``torch`` and never JAX or ``cm3_tpu``; the tests hold each
module against its ``cm3_tpu`` counterpart on the CPU.  Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
