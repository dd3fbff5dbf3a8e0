"""Backbone, heads and the SiamMask-sharp assembly (NCHW ``nn.Module``s)."""
