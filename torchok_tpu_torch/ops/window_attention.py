"""Constants shared by the window-attention ops.

SwinV2 clamps the learned log temperature at ln(100) (natural log): the
reference's clamp(max=log(100)) caps the effective scale at 100.
"""
import math

LN_100 = math.log(100.0)
