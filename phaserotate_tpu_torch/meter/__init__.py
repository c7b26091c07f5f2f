"""Metering: peak/momentary/gain-diff ballistics with delay alignment."""

from .meter import (
    DIFF_GATE,
    FALL_DB_PER_S,
    HOLD_SECONDS,
    MeterConfig,
    MeterLevels,
    MeterState,
    delay_line_update,
    host_meter_block,
    host_meter_state,
    host_reset_peaks,
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
    "host_meter_block",
    "host_meter_state",
    "host_reset_peaks",
    "init_meter_state",
    "meter_block",
    "meter_falloff",
    "reset_peaks",
]
