"""Plugin layer: lifecycle ABI, protocol, metadata, host descriptors.

A copy of ``phaserotate_tpu/plugin/__init__.py``, which holds no JAX: that
package's ``__init__`` imports JAX, and this port runs where JAX is
absent, so it keeps its own copy; its relative imports reach the port's
own ``plugin.lifecycle``.  Only these lines differ;
``tests/test_torch_io.py`` holds the rest to its source.
"""

from .descriptors import (
    PLUGIN_MONO,
    PLUGIN_STEREO,
    HostDescriptor,
    PortDesc,
    descriptor_for_channels,
)
from .lifecycle import PhaseRotatePlugin, descriptors
from .protocol import (
    LevelsMsg,
    Message,
    ResetPeaks,
    StateMsg,
    UiOff,
    UiOn,
    decode,
    encode,
)
from .ttl import manifest_ttl, plugin_ttl, write_bundle
from .uris import (
    MAX_CHANNELS,
    PLUGIN_URI,
    PLUGIN_URI_STEREO,
    PortIndex,
    Prot,
)

__all__ = [
    "HostDescriptor",
    "LevelsMsg",
    "MAX_CHANNELS",
    "Message",
    "PLUGIN_MONO",
    "PLUGIN_STEREO",
    "PLUGIN_URI",
    "PLUGIN_URI_STEREO",
    "PhaseRotatePlugin",
    "PortDesc",
    "PortIndex",
    "Prot",
    "ResetPeaks",
    "StateMsg",
    "UiOff",
    "UiOn",
    "decode",
    "descriptor_for_channels",
    "descriptors",
    "encode",
    "manifest_ttl",
    "plugin_ttl",
    "write_bundle",
]
