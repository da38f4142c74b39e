"""dynamo_tpu_torch: the PyTorch/CUDA port of dynamo_tpu's engine core.

A second package beside the JAX reference (`dynamo_tpu`), for one NVIDIA
H100. It imports torch, numpy and the standard library only: nothing of JAX
and nothing of `dynamo_tpu`. Kernels are CUDA C++ for sm_90a under
`ops/csrc/`, built with nvcc at first use and bound with ctypes.

Entry points (`engine.TorchWorker`, `engine.ModelRunner`,
`models.init_params`) run on the card unless the caller passes
`device="cpu"`; with no card they raise instead of falling back.
"""
