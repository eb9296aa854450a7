"""The benchmark's plain reference: the seg+track step in fp32 PyTorch.

A frozen, independent copy of the arithmetic the program under test computes:
the letterbox, the YOLOv10 seg forward, the NMS-free top-k, the best slot's mask,
the tracker's key encoder, memory readout, decoder head and sensory GRU, memory
write and decode tail, and the id maps.  Module and parameter names follow the
ultralytics / flax layouts, so one state dict fits the reference and the program.

It imports nothing of the program, of JAX or of the JAX package; plain
``torch.nn.functional`` calls and matmuls only, fp32, no kernels, no caches.
Every matrix product goes through a ``Numerics`` object: ``FP32`` leaves its
operands as they are; ``Fp8Numerics()`` rounds both operands and the result of
every convolution and matmul to fp8 (e4m3, one scale per tensor), which is the
benchmark's control: the nearest precision below the configuration's bf16.
"""
