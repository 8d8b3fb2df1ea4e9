"""PyTorch/CUDA port of ``euromillioner_tpu``.

The JAX package beside this one is the reference; this package mirrors its
module paths and names so each counterpart is easy to find, and imports
neither ``jax`` nor anything of ``euromillioner_tpu``. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; on a CPU tensor every
hand-written kernel's wrapper takes the kernel's plain PyTorch version.

Ported so far: the flagship LSTM's train → checkpoint → serve path.
Training (``train --model lstm``): ETL from a saved results page or a
featurized CSV, sliding windows, the Trainer with {train, test} watches,
the four optimizers, TrainState checkpoints that either package restores.
Serving (``serve --model-type lstm``): whole-sequence batching under the
``f32`` and ``fused`` profiles. The fused LSTM's forward and backward
kernels are written in CUDA (``csrc/fused_lstm.cu``,
``csrc/fused_lstm_bwd.cu``) and joined as one autograd Function.
Gradient-boosted trees (``trees/``, ``app.py``, ``train --model gbt``,
``predict``, ``reference``): the reference's Main.java pipeline, with the
per-level split histogram in a CUDA kernel (``csrc/fused_histogram.cu``).
"""

__version__ = "0.1.0"
