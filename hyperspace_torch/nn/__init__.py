"""Layers, scatters and decoders (counterpart of ``hyperspace_tpu.nn``)."""

from hyperspace_torch.nn.layers import HypAct, HypLinear, LorentzLinear

__all__ = ["HypLinear", "LorentzLinear", "HypAct"]
