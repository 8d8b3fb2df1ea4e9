"""Neural layers: Module/Sequential, Dense, Dropout, LSTM."""

from euromillioner_tpu_torch.nn.layers import Dense, Dropout
from euromillioner_tpu_torch.nn.module import Module, Sequential
from euromillioner_tpu_torch.nn.recurrent import LSTM, LSTMCell

__all__ = ["Dense", "Dropout", "LSTM", "LSTMCell", "Module", "Sequential"]
