"""Frame-blocked analysis of one long utterance over a local mesh.

Port of ``tpuvc/parallel/frame_sharding.py:analyze_sharded``, step for
step.  The analysis is O(T) with only local context (every window spans at
most ``MAX_ANALYSIS_WINDOW`` samples around its frame), so one utterance's
frame axis is cut into contiguous blocks, one per device of the mesh.
DIO's f0 contour stays global: its event machinery and contour fixing scan
the whole utterance, so it runs once, on the first device.  Each device
then slices its block plus a halo of frames on both sides (covering the
windows of its edge frames) and the matching span of the signal, runs the
frame-local stages (StoneMask, CheapTrick, D4C) on it from a thread of its
own, and drops the halo: no exchange between devices, because every block
reads the whole signal.

The JAX function is the reference, and its choices are kept: the f0 is
DIO's whatever ``cfg.f0_method`` says, and D4C runs its default group-delay
method whatever ``cfg.ap_method`` says.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tpuvc_torch.dsp.cheaptrick import cheaptrick
from tpuvc_torch.dsp.constants import (DEFAULT_WORLD, MAX_ANALYSIS_WINDOW,
                                       WorldConfig)
from tpuvc_torch.dsp.d4c import d4c
from tpuvc_torch.dsp.dio import dio
from tpuvc_torch.dsp.stonemask import stonemask
from tpuvc_torch.dsp.world import WorldFeatures
from tpuvc_torch.parallel.mesh import DataMesh, run_shards


@torch.no_grad()
def analyze_sharded(x, mesh: DataMesh,
                    cfg: WorldConfig = DEFAULT_WORLD) -> WorldFeatures:
    """Analyze one utterance x [T] (array or tensor) with its frame axis
    split over a local mesh; returns the features of ``dsp.world.analyze``
    on the mesh's first device.  The frame count is padded up to a multiple
    of the mesh size; the extra frames analyse trailing silence and are cut
    off."""
    if mesh.is_process_group:
        raise ValueError("analyze_sharded runs over a local mesh "
                         "(make_mesh), not a process group")
    hop, fs, fft = cfg.hop, cfg.fs, cfg.fft_size
    dev0 = mesh.devices[0]
    if not torch.is_tensor(x):
        x = np.asarray(x, np.float32)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev0)
    n_dev = mesh.size
    n_frames = x.shape[0] // hop + 1
    block = -(-n_frames // n_dev)
    n_pad = block * n_dev
    halo = -(-(MAX_ANALYSIS_WINDOW // 2) // hop)       # frames per side

    # f0: global (DIO's contour fixing scans the whole utterance)
    f0_full = dio(x[None], fs=fs, hop=hop, f0_floor=cfg.f0_floor,
                  f0_ceil=cfg.f0_ceil)[0]
    # zero-padded, so that every block slices block + 2 halo frames and
    # the matching signal span without bounds checks
    f0_ext = F.pad(f0_full, (halo, n_pad - n_frames + halo))
    x_ext = F.pad(x, (halo * hop, (n_pad + halo) * hop + fft))

    def block_fn(i: int, d: torch.device):
        s = i * block
        f0_loc = f0_ext[s:s + block + 2 * halo].to(d)[None]
        x_loc = x_ext[s * hop:(s + block + 2 * halo) * hop + fft].to(d)[None]
        # local frame j is global frame s + j - halo: the centres line up
        # because x_loc starts at global sample (s - halo) * hop
        f0_r = stonemask(x_loc, f0_loc, hop=hop, fs=fs)
        sp = cheaptrick(x_loc, f0_r, hop=hop, fs=fs, fft_size=fft)
        ap = d4c(x_loc, f0_r, hop=hop, fs=fs, fft_size=fft)
        keep = slice(halo, halo + block)
        return f0_r[0, keep], sp[0, keep], ap[0, keep]

    blocks = run_shards(mesh, block_fn)
    f0, sp, ap = (torch.cat([b[k].to(dev0) for b in blocks])[:n_frames]
                  for k in range(3))
    return WorldFeatures(f0=f0, sp=sp, ap=ap)
