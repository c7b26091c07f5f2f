"""Metering: peak/momentary/gain-diff ballistics with delay alignment."""

from .meter import (
    DIFF_GATE,
    FALL_DB_PER_S,
    HOLD_SECONDS,
    MeterConfig,
    MeterLevels,
    MeterState,
    delay_line_update,
    init_meter_state,
    meter_block,
    meter_falloff,
    reset_peaks,
)

__all__ = [
    "DIFF_GATE",
    "FALL_DB_PER_S",
    "HOLD_SECONDS",
    "MeterConfig",
    "MeterLevels",
    "MeterState",
    "delay_line_update",
    "init_meter_state",
    "meter_block",
    "meter_falloff",
    "reset_peaks",
]
