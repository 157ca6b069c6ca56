from bolt_tpu_torch.gpu.array import BoltArrayGPU
from bolt_tpu_torch.gpu.construct import ConstructGPU

__all__ = ["BoltArrayGPU", "ConstructGPU"]
