"""Request images made on the device from the seed, by a traffic file's
"frames" parameters (the configuration's "calibration_frames" for the
darknet's calibration): a scene a frame, a background colour with a linear
ramp, `blobs` soft-edged discs of their own colour, radius and place, and a
little pixel noise, so that no two frames look alike (noise frames did, and
an answer from another frame read nearly sound) and a map's features vary
smoothly over many cells.

  blobs       [min, max] discs a frame
  radius      [min, max] pixels
  background  [min, max] of each background channel
  ramp        the largest change of a channel across the frame
  edge        the discs' soft edge, pixels
  noise       pixel noise, uniform in [-noise, noise]

Images are (B, H, W, 3) float32 in [0, 1], made in a few large draws.
"""

from __future__ import annotations

import torch


def make(spec: dict, B: int, H: int, W: int, g: torch.Generator, device) -> torch.Tensor:
    lo_n, hi_n = spec["blobs"]
    K = int(hi_n)
    u = lambda *shape: torch.rand(shape, generator=g, device=device)
    span = lambda x, lo_hi: lo_hi[0] + (lo_hi[1] - lo_hi[0]) * x
    bg = span(u(B, 1, 1, 3), spec["background"])
    ramp = spec["ramp"] * (2.0 * u(B, 2, 1, 1, 3) - 1.0)
    y = torch.linspace(-0.5, 0.5, H, device=device)[None, :, None, None]
    x = torch.linspace(-0.5, 0.5, W, device=device)[None, None, :, None]
    img = bg + ramp[:, 0] * x + ramp[:, 1] * y
    count = lo_n + torch.floor(u(B) * (hi_n - lo_n + 1))
    cy, cx = u(B, K) * H, u(B, K) * W
    r = span(u(B, K), spec["radius"])
    colour = u(B, K, 3)
    yy = torch.arange(H, device=device, dtype=torch.float32)[None, :, None]
    xx = torch.arange(W, device=device, dtype=torch.float32)[None, None, :]
    for k in range(K):
        d = torch.sqrt((yy - cy[:, k, None, None]) ** 2 + (xx - cx[:, k, None, None]) ** 2)
        alpha = torch.sigmoid((r[:, k, None, None] - d) / spec["edge"])
        alpha = (alpha * (k < count)[:, None, None].float())[..., None]
        img = img * (1.0 - alpha) + colour[:, k, None, None, :] * alpha
    img = img + spec["noise"] * (2.0 * u(B, H, W, 3) - 1.0)
    return img.clamp_(0.0, 1.0).contiguous()
