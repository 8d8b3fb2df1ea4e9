"""PyTorch/CUDA port of ``euromillioner_tpu``.

The JAX package beside this one is the reference; this package mirrors its
module paths and names so each counterpart is easy to find, and imports
neither ``jax`` nor anything of ``euromillioner_tpu``. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; on a CPU tensor every
hand-written kernel's wrapper takes the kernel's plain PyTorch version.

Ported so far: whole-sequence LSTM serving (``serve --model-type lstm``)
under the ``f32`` and ``fused`` profiles, with the fused LSTM forward
kernel written in CUDA (``csrc/fused_lstm.cu``).
"""

__version__ = "0.1.0"
