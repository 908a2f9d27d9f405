"""Physical constants of the wave model.

Copied unchanged from ``ecwam_tpu/core/constants.py`` (numpy only, no
JAX), with its imports pointed at ``wavebench.reference.ecw``: the port
imports nothing of the JAX package.

Re-derivation of the reference constant module
(yowpcons.F90:16-69).  All values are plain Python
floats (double precision); compute kernels cast them to the model dtype at
trace time.
"""

from __future__ import annotations

import math

# Gravity & geometry (yowpcons.F90:19-32)
# The reference hard-codes single-precision-era decimal literals for π and
# its derived constants (yowpcons.F90:21-31: ZPI=6.2831854 ≠ 2π, …).  We adopt
# the same literals so f64 runs are term-by-term comparable with the
# reference numerics (oracle tests in tests/oracle/ pin this at ≤1e-10); the
# ~1e-8 relative deviation from true π is far below operational f32 noise.
G = 9.806
GM1 = 0.101978381                  # 1/G rounded as in yowpcons.F90:20
PI = 3.1415927                     # yowpcons.F90:21-22 (OLDPI)
ZPI = 6.2831854                    # yowpcons.F90:24
THREEZPI = 18.849555922            # yowpcons.F90:25
ZPI4GM1 = 158.93794172             # (2π)⁴/g   (yowpcons.F90:26)
ZPI4GM2 = 16.208233910             # (2π)⁴/g²  (yowpcons.F90:27)
ZPISQRT = 1.7724539                # yowpcons.F90:28
RAD = 0.017453293                  # yowpcons.F90:30
DEG = 57.295778667                 # yowpcons.F90:31
R_EARTH = 6367470.0                # radius of the earth (m)
CIRC = 40007993.95                 # circumference of the earth (m)

# Numerical floors/caps (yowpcons.F90:33-39)
EPSMIN = 0.1e-32
DKMAX = 40.0                       # max deep-water k*d in dispersion solve
TAUOCMIN = 0.01
TAUOCMAX = 50.0
PHIEPSMIN = -3276.80
PHIEPSMAX = -0.05
WSEMEAN_MIN = 0.001
ZMISS = -999.0

# Densities (yowpcons.F90:41-45)
ROAIR = 1.225                      # air density (kg/m³)
ROWATER = 1000.0                   # water density (kg/m³)
ROWATERM1 = 1.0 / ROWATER
YEPS = ROAIR / ROWATER
YINVEPS = ROWATER / ROAIR

# Surface tension (gravity-capillary model, yowpcons.F90:46-48)
GAM_SURF = 0.0717
SURFT = 0.0000717                  # surface tension / water density
SQRTGOSURFT = math.sqrt(G / SURFT)

WSTAR0 = 0.0
R_GAS = 287.16                     # gas constant (yowpcons.F90:50)
EPS_WATER_VAPOR = 0.61

# Friction-velocity / wind floors (yowpcons.F90:52-53)
EPSUS = 1.0e-6
EPSU10 = math.sqrt(1.0e-3)

# Drag-coefficient fits (yowpcons.F90:55-66)
ACD = 8.0e-4                       # CD = ACD + BCD*U10 (tauw cap at low wind)
BCD = 8.0e-5
ACDLIN = 0.0008
BCDLIN = 0.00047
C1CD = 1.03e-3
C2CD = 0.04e-3
P1CD = 1.48
P2CD = -0.21
CDMAX = 0.0025

FM2FP = 0.9                        # mean freq to peak freq ratio (yowpcons.F90:68)
NPMAX = 20
