"""The V-channel refinement of pseudo-masks, on the images' device.

The reference thresholds the V channel of ``cv2.cvtColor(img,
cv2.COLOR_BGR2HSV)`` at 170 (``cv2.THRESH_BINARY``: strictly greater is
foreground) and intersects the inverted result with the tile mask. The
images are RGB fed through the BGR flag, which leaves V = max(channels)
unchanged, so the refinement is ``keep = mask & (max channel <= 170)``.
"""

from __future__ import annotations

import torch


def rgb_value_channel(images: torch.Tensor) -> torch.Tensor:
    """OpenCV's HSV V channel of uint8 images [..., H, W, 3]: the max over
    the channels."""
    return images.amax(dim=-1)


def hsv_refine_mask(images: torch.Tensor, masks: torch.Tensor,
                    value_threshold: int = 170) -> torch.Tensor:
    """bool [..., H, W]: ``masks`` (bool or 0/1) where the V channel of
    ``images`` (uint8 [..., H, W, 3]) is at most ``value_threshold``.
    Small-region removal comes after, in the postprocess layer."""
    bright = rgb_value_channel(images) > value_threshold
    return masks.to(torch.bool) & ~bright
