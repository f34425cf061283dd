from .base import ControlEnvironmentBase, SREnvironmentBase, time_varying
from .control_envs import (
    Acrobot, Acrobot2, CartPole, ChangingHarmonicOscillator, HarmonicOscillator,
    HarmonicOscillator2, StirredTankReactor,
)
from .sr_envs import LorenzAttractor, LotkaVolterra, VanDerPolOscillator

__all__ = ["Acrobot", "Acrobot2", "CartPole", "ChangingHarmonicOscillator",
           "ControlEnvironmentBase", "HarmonicOscillator", "HarmonicOscillator2",
           "LorenzAttractor", "LotkaVolterra", "SREnvironmentBase", "StirredTankReactor",
           "VanDerPolOscillator", "time_varying"]
