"""PyTorch port of the ``repro`` package for one NVIDIA Hopper GPU.

The layout mirrors ``repro`` module for module. The dp ranks of a mesh are
dim 0 of "stacked" tensors on the one device (``launch/mesh.py``). The
paper's allgathers move shards between them with a hand-written kernel
that runs a gather's whole ring schedule in one launch, their backward runs
the transposed ring steps (``kernels/ring_allgather.py``),
and every product of a gathered weight runs on a hand-written matmul
kernel (``kernels/collective_matmul.py``). The packet-level reliable
Broadcast (``core/packet.py``) keeps its leaves' receive datapath on the
device: the worker-pool scan (``kernels/pool.py``), the NACK bitmaps
(``kernels/bitmap.py``) and, for the delivery replay, chunk reassembly
(``kernels/chunk_reassembly.py``). The CUDA sources are in ``csrc/``.
Importing the package needs neither a GPU nor ``nvcc``: kernels are built
at first launch (``kernels/build.py``).
"""
