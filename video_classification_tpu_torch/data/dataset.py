"""Clip-tensor constants shared by the preprocessing and the model input.

A clip is (T, H, W, 21) uint8: 0:3 BGR, 3:5 UV, 5:20 flow (5 frames x 3
channels), 20:21 depth. A missing part crop is filled with 127.
"""

NUM_MODALITY_CHANNELS = 21
MISSING_FILL = 127
