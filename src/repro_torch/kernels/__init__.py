"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

``decode_attention``, ``fake_quant`` (forward and backward) and
``quant_matmul`` launch a kernel built from ``csrc/`` for CUDA tensors and
run their plain version (``ref.py``) for CPU tensors; anything else raises.
``ops.py`` holds the deployed linear and the fused fake-quant.
"""
