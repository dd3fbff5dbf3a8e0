"""Benchmark datasets, the VOT region overlap and the eval toolkit (VOT
A/R/EAO, DAVIS and YouTube-VOS J&F) for the port; numpy, cv2 and PIL, no
torch."""
