from .base import SREnvironmentBase
from .sr_envs import LorenzAttractor, LotkaVolterra, VanDerPolOscillator

__all__ = ["SREnvironmentBase", "LorenzAttractor", "LotkaVolterra", "VanDerPolOscillator"]
