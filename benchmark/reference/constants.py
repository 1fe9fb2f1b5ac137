"""DSP constants and the analysis configuration of the port.

The port's own copy of what it uses from ``tpuvc/dsp/constants.py``:
every value, function and ``WorldConfig`` field has the same name and
value there, so one set of fields builds both sides of a parity test
(``tests/test_torch_dsp.py`` holds the two files equal).  Provenance of
each constant (WORLD's papers and reconstructed values) is documented in
the JAX module.

Frozen plain copy of ``tpuvc_torch/dsp/constants.py`` for the benchmark's
reference: no hand kernel, nothing imported from the port.
"""

from __future__ import annotations

import dataclasses
import math

# --- corpus / feature geometry ---
FS = 16000
FRAME_PERIOD_MS = 5.0
HOP = int(FS * FRAME_PERIOD_MS / 1000.0)      # 80 samples / frame
FFT_SIZE = 1024
SP_DIM = FFT_SIZE // 2 + 1                    # 513
FEAT_DIM = SP_DIM * 2 + 2                     # sp + ap + f0 + en = 1028
RECORD_DIM = FEAT_DIM + 1                     # + speaker label = 1029
RECORD_BYTES = RECORD_DIM * 4
EPSILON = 1e-10                               # log floor of the envelope

# --- f0 search range ---
F0_FLOOR = 71.0
F0_CEIL = 800.0

# --- DIO ---
DIO_CHANNELS_IN_OCTAVE = 2.0
DIO_ALLOWED_RANGE = 0.1
DIO_TARGET_FS = 4000.0
DIO_VOICE_RANGE_MINIMUM = 9
DIO_SCORE_CUTOFF = 0.2

# --- Harvest ---
HARVEST_CHANNELS_IN_OCTAVE = 40.0
HARVEST_TARGET_FS = 8000.0
HARVEST_FLOOR_ADJUST = 0.9
HARVEST_CEIL_ADJUST = 1.1
HARVEST_CONSISTENCY = 0.2
HARVEST_BAND_GATE_HIGH = 1.1
HARVEST_MERGE_TOLERANCE = 0.03
HARVEST_MAX_CANDIDATES = 10
HARVEST_REFINE_LIMIT = 0.2
HARVEST_RESELECT_HALF = 15
HARVEST_RESELECT_REL = 0.15
HARVEST_STEP1_ALLOWED = 0.03
HARVEST_VOICE_RANGE_MIN = 9
HARVEST_EXTENSION_ALLOWED = 0.05
HARVEST_SMOOTH_B = (0.0078202080334971724, 0.015640416066994345,
                    0.0078202080334971724)
HARVEST_SMOOTH_A1 = -1.7347257688092754
HARVEST_SMOOTH_A2 = 0.76600660094326412


def harvest_refine_window(fs: int, f0_floor: float) -> int:
    """Refinement buffer length: 3 Blackman periods at the adjusted floor,
    padded to a multiple of 128 (768 at fs=16k / floor 71 Hz)."""
    floor = f0_floor * HARVEST_FLOOR_ADJUST
    need = 2 * int(1.5 * fs / floor + 1.0) + 1
    return -(-need // 128) * 128


# --- StoneMask ---
STONEMASK_NUM_HARMONICS = 6
STONEMASK_RELATIVE_LIMIT = 0.2
STONEMASK_FFT_SIZE = 1024


def max_refined_f0(f0_ceil: float = F0_CEIL) -> float:
    """Largest f0 any estimator can hand downstream stages (1056 Hz at the
    default ceiling): StoneMask's +20% over Harvest's widened ceiling."""
    return f0_ceil * (1.0 + STONEMASK_RELATIVE_LIMIT) * HARVEST_CEIL_ADJUST


# --- CheapTrick ---
CHEAPTRICK_Q1 = -0.15
CHEAPTRICK_DEFAULT_F0 = 500.0


def cheaptrick_fft_size(fs: int, f0_floor: float = F0_FLOOR) -> int:
    """WORLD: fft_size = 2 ** (1 + floor(log2(3 fs / f0_floor + 1)))."""
    return 2 ** (1 + int(math.log2(3.0 * fs / f0_floor + 1.0)))


def cheaptrick_f0_floor(fs: int, fft_size: int = FFT_SIZE) -> float:
    """Lowest f0 the FFT size supports: 3 fs / (fft_size - 3)."""
    return 3.0 * fs / (fft_size - 3.0)


# --- D4C ---
D4C_THRESHOLD = 0.85
D4C_FREQUENCY_INTERVAL = 3000.0
D4C_UPPER_LIMIT = 15000.0
D4C_FLOOR_DB = -60.0
D4C_CEIL_DB = -1e-12
D4C_UNVOICED_PLACEHOLDER_F0 = 150.0
SAFE_GUARD_MINIMUM = 1e-12
# the NCCF variant's autocorrelation headroom, and the bound of every
# stage's analysis window: the halo of frame-sharded analysis
# (parallel/frame_sharding.py) derives from it
D4C_FFT_SIZE = 2048
MAX_ANALYSIS_WINDOW = D4C_FFT_SIZE


def d4c_fft_size(fs: int, f0_floor: float = F0_FLOOR) -> int:
    """FFT size covering D4C's 4-period windows:
    2 ** (1 + floor(log2(4 fs / f0_floor + 1))) (1024 at 16 kHz)."""
    return 2 ** (1 + int(math.log2(4.0 * fs / f0_floor + 1.0)))


def d4c_num_bands(fs: int) -> int:
    """Number of 3 kHz coarse aperiodicity bands."""
    return int(min(D4C_UPPER_LIMIT, fs / 2.0 - D4C_FREQUENCY_INTERVAL)
               / D4C_FREQUENCY_INTERVAL)


# --- synthesis ---
SYNTH_NOISE_SEED = 0            # default seed of the aperiodic source


@dataclasses.dataclass(frozen=True)
class WorldConfig:
    """Analysis/synthesis configuration."""

    fs: int = FS
    frame_period_ms: float = FRAME_PERIOD_MS
    f0_floor: float = F0_FLOOR
    f0_ceil: float = F0_CEIL
    fft_size: int = FFT_SIZE
    ap_method: str = "group_delay"   # D4C statistic: "group_delay" or "nccf"
    f0_method: str = "dio"           # "dio" (+ StoneMask) or "harvest"
    harvest_channel_decim: int = 1   # 1 = WORLD's 1/40-octave bank

    @property
    def hop(self) -> int:
        return int(self.fs * self.frame_period_ms / 1000.0)

    @property
    def sp_dim(self) -> int:
        return self.fft_size // 2 + 1

    def num_frames(self, num_samples: int) -> int:
        """WORLD frame count: floor(T / hop) + 1 frames at t = i * hop."""
        return num_samples // self.hop + 1


DEFAULT_WORLD = WorldConfig()
