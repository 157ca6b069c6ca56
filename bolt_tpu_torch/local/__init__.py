from bolt_tpu_torch.local.array import BoltArrayLocal
from bolt_tpu_torch.local.construct import ConstructLocal

__all__ = ["BoltArrayLocal", "ConstructLocal"]
