"""The SiamMask training step: LR schedules, optimizer groups, freeze schedule."""
