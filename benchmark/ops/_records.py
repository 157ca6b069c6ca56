"""Helpers the step modules share: a sample of an array's records,
copied on the card (the program's outputs that a comparison reads)."""

import torch


def sampled(arr, idx):
    """Records ``idx`` (flat over the key axes) of the bolt array ``arr``,
    copied, as a ``(len(idx),) + record shape`` tensor."""
    t = arr.totorch()
    rec = t.reshape((-1,) + tuple(t.shape[arr.split:]))
    return rec[torch.as_tensor(idx, device=t.device)].clone()
