"""Neural layers: Module/Sequential, Dense, Embedding, Dropout, LayerNorm,
Activation, Flatten, LSTM."""

from euromillioner_tpu_torch.nn.layers import (Activation, Dense, Dropout,
                                               Embedding, Flatten, LayerNorm)
from euromillioner_tpu_torch.nn.module import Module, Sequential
from euromillioner_tpu_torch.nn.recurrent import LSTM, LSTMCell

__all__ = ["Activation", "Dense", "Dropout", "Embedding", "Flatten",
           "LSTM", "LSTMCell", "LayerNorm", "Module", "Sequential"]
