"""Plain PyTorch references that ``correct`` is judged against.

They implement each configuration as its file states it, from the raw
inputs that ``cardbench.inputs`` makes, and import nothing of the port and
nothing of JAX.
"""
