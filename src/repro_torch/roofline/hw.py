"""Target-hardware model: one NVIDIA H100 SXM 80GB (counterpart of
``repro/roofline/hw.py``, whose figures are a TPU's; none is carried over).

The fields keep the reference's meanings. Each figure's source:

* ``peak_flops_bf16``: 989 TFLOP/s, dense BF16 Tensor Core (without
  sparsity), H100 SXM, NVIDIA H100 Tensor Core GPU datasheet;
* ``hbm_bw``: 3.35 TB/s of HBM3, H100 SXM, the same datasheet;
* ``hbm_bytes``: 80 GB, H100 SXM, the same datasheet;
* ``vmem_bytes``, the fast memory next to the compute units: 228 KB of
  shared memory per SM (kilobytes of 1,024 bytes), NVIDIA H100 Tensor Core
  GPU Architecture whitepaper;
* ``ici_link_bw``, the bandwidth one device has for a collective: 400 Gb/s
  = 50 GB/s, one ConnectX-7 NDR port per GPU, NVIDIA DGX H100 datasheet.
  The inter-node figure, since every 16-wide axis of the production mesh
  spans more than one 8-GPU node (NVLink inside a node is faster).
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class HWModel:
    name: str = "h100-sxm-80gb"
    peak_flops_bf16: float = 989e12      # FLOP/s per GPU
    hbm_bw: float = 3.35e12              # bytes/s per GPU
    ici_link_bw: float = 50e9            # bytes/s per GPU, inter-node
    hbm_bytes: float = 80e9              # capacity per GPU
    vmem_bytes: float = 228 * 1024       # shared memory per SM


HW = HWModel()
