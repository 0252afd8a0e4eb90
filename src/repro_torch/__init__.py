"""PyTorch port of the ``repro`` package for one NVIDIA Hopper GPU.

The layout mirrors ``repro`` module for module. The dp ranks of a mesh are
dim 0 of "stacked" tensors on the one device (``launch/mesh.py``), and the
paper's allgathers move shards between them with a hand-written ring-step
kernel (``kernels/ring_allgather.py``, ``csrc/ring_step.cu``). Importing the
package needs neither a GPU nor ``nvcc``: kernels are built at first launch.
"""
