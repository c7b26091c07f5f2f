"""High-level model families: streaming/offline rotators, angle analyzer."""

from .analyzer import AngleAnalyzer
from .rotator import OfflineRotator, PhaseRotator

__all__ = ["AngleAnalyzer", "OfflineRotator", "PhaseRotator"]
