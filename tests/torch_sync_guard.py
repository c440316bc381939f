"""A torch function mode that fails any read of a tensor's values on the
host: ``.item()``, ``.tolist()``, ``.numpy()``, ``.cpu()``, truth and
number conversions, ``nonzero`` and boolean-mask indexing (a result
whose shape depends on the data). On a CUDA tensor each of these waits
for the device, and none can be captured in a CUDA graph; the CPU tests
run code under this mode to show it does none of them."""

import torch
from torch.overrides import TorchFunctionMode

_READS = {torch.Tensor.item, torch.Tensor.tolist, torch.Tensor.numpy,
          torch.Tensor.cpu, torch.Tensor.__bool__, torch.Tensor.__int__,
          torch.Tensor.__float__, torch.Tensor.__index__, torch.nonzero,
          torch.Tensor.nonzero, torch.masked_select,
          torch.Tensor.masked_select, torch.argwhere, torch.unique}


def _bool_index(index) -> bool:
    items = index if isinstance(index, tuple) else (index,)
    return any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
               for i in items)


class NoHostReads(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in _READS or (
                func in (torch.Tensor.__getitem__, torch.Tensor.__setitem__)
                and _bool_index(args[1])):
            raise AssertionError(f"host read of a tensor value: {func}")
        return func(*args, **(kwargs or {}))
