"""The plain reference: the models' forward passes, their loss and Adam in
plain PyTorch, float32 with TF32 off unless a control asks for less.

It imports nothing of the program. Every function takes ``q``, the
rounding applied where the configured compute dtype rounds (operands of
each product, each layer's output): the identity for the reference, a
lower precision for the control (``perfbench/yardstick/lowp.py``).
"""
