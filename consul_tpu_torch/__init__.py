"""PyTorch/CUDA port of the SWIM gossip round of ``consul_tpu``.

The JAX package ``consul_tpu`` stays the reference; this package is held
bit-for-bit against it (``tests/test_torch_*.py``).  It imports torch and
numpy only — never JAX, and nothing of ``consul_tpu``: what it needs from
there (protocol parameters, observability column layouts, the
divisibility contract) it keeps as its own copies.

Every entry point takes ``device=None``: ``None`` means the CUDA card,
``device="cpu"`` is the only way onto the CPU, and with no card and no
explicit CPU request the entry point raises rather than quietly running
on the CPU (``consul_tpu_torch._device``).
"""
