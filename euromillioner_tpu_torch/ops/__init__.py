"""Hand-written CUDA kernels for Hopper (sources in ../csrc/), each with
its plain PyTorch version beside it. Importing the package registers the
custom ops that serving programs reach (``emtpu::lstm_sequence``, K1;
``emtpu::wide_onehot_fwd``, K4a), so they exist before any program
compiled ahead of time is loaded."""

from euromillioner_tpu_torch.ops import fused_lstm, wide_onehot  # noqa: F401
