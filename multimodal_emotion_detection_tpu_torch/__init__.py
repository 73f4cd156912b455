"""PyTorch / CUDA port of multimodal_emotion_detection_tpu.

A second package beside the JAX one, with the same module paths.  It
imports torch, numpy and yaml, never JAX or the JAX package.  Its entry
points run on the CUDA card unless ``runtime.platform=cpu`` asks for the
CPU; on the card every TPU kernel of a ported path is a hand-written CUDA
kernel (``csrc/``), built with nvcc on first use.
"""
