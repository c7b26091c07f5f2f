"""LV2 TTL metadata generation.

A copy of ``phaserotate_tpu/plugin/ttl.py``, which holds no JAX: that
package's ``__init__`` imports JAX, and this port runs where JAX is
absent, so it keeps its own copy.  Only these lines differ;
``tests/test_torch_io.py`` holds the rest to its source.

Emits the Turtle bundle metadata equivalent to the reference's generated
TTL (lv2ttl/phaserotate.ports.in, phaserotate.mono.in, phaserotate.
stereo.in, manifest.ttl.in): the same port declarations — atom
control/notify with 4096-byte minimum size, reportsLatency control output
bounded at 8192, per-channel angle ControlPort -180..180 default 0 with 9
scalePoints and 721 rangeSteps, audio in/out pairs — and the urid:map
feature line.

Unlike the reference (lv2ttl/phaserotate.ports.in:7) the bundle does NOT
declare ``lv2:hardRTCapable``: the shipped binary is the socket shim
(native/prt_lv2.cc) whose run() blocks on an engine round trip — a
bounded soft-real-time path when the daemon runs with ``--pipeline N``
(see stream/host.py), but not the allocation-free lock-free hard-RT
contract the feature promises.  Claiming it would be a lie to the host's
scheduler; the honest latency/throughput figures live in bench.py's
streaming benchmark instead.
"""

from __future__ import annotations

from typing import List

from .uris import PLUGIN_URI, PLUGIN_URI_STEREO

__all__ = ["manifest_ttl", "plugin_ttl", "write_bundle"]

_PREFIXES = """@prefix atom:  <http://lv2plug.in/ns/ext/atom#> .
@prefix doap:  <http://usefulinc.com/ns/doap#> .
@prefix foaf:  <http://xmlns.com/foaf/0.1/> .
@prefix lv2:   <http://lv2plug.in/ns/lv2core#> .
@prefix pprops: <http://lv2plug.in/ns/ext/port-props#> .
@prefix rdfs:  <http://www.w3.org/2000/01/rdf-schema#> .
@prefix rsz:   <http://lv2plug.in/ns/ext/resize-port#> .
@prefix units: <http://lv2plug.in/ns/extensions/units#> .
@prefix urid:  <http://lv2plug.in/ns/ext/urid#> .
"""

_SCALE_POINTS = [
    (-180, "-180 deg"), (-135, "-135 deg"), (-90, "-90 deg"),
    (-45, "-45 deg"), (0, "0 deg"), (45, "+45 deg"), (90, "+90 deg"),
    (135, "+135 deg"), (180, "+180 deg"),
]


def _fixed_ports() -> str:
    return """	lv2:port [
		a atom:AtomPort, lv2:InputPort ;
		atom:bufferType atom:Sequence ;
		lv2:index 0 ;
		lv2:symbol "control" ;
		lv2:name "Control" ;
		rsz:minimumSize 4096 ;
	] , [
		a atom:AtomPort, lv2:OutputPort ;
		atom:bufferType atom:Sequence ;
		lv2:index 1 ;
		lv2:symbol "notify" ;
		lv2:name "Notify" ;
		rsz:minimumSize 4096 ;
	] , [
		a lv2:ControlPort, lv2:OutputPort ;
		lv2:index 2 ;
		lv2:symbol "latency" ;
		lv2:name "Signal Latency" ;
		lv2:minimum 0 ;
		lv2:maximum 8192 ;
		lv2:portProperty lv2:reportsLatency, lv2:integer ;
		units:unit units:frame ;
	]"""


def _channel_ports(chn: int, index0: int, suffix: str) -> str:
    scale_points = " ,\n\t\t\t".join(
        f'[ rdfs:label "{lbl}" ; rdf:value {val:.1f} ]'
        for val, lbl in _SCALE_POINTS
    )
    return f""" , [
		a lv2:InputPort, lv2:ControlPort ;
		lv2:index {index0} ;
		lv2:symbol "angle{suffix}" ;
		lv2:name "Phase Angle{suffix}" ;
		lv2:default 0.0 ;
		lv2:minimum -180.0 ;
		lv2:maximum 180.0 ;
		lv2:scalePoint {scale_points} ;
		pprops:rangeSteps 721 ;
		units:unit units:degree ;
	] , [
		a lv2:AudioPort, lv2:InputPort ;
		lv2:index {index0 + 1} ;
		lv2:symbol "in{suffix}" ;
		lv2:name "Audio Input{suffix}" ;
	] , [
		a lv2:AudioPort, lv2:OutputPort ;
		lv2:index {index0 + 2} ;
		lv2:symbol "out{suffix}" ;
		lv2:name "Audio Output{suffix}" ;
	]"""


def plugin_ttl(version_minor: int = 0, version_micro: int = 0) -> str:
    """Full plugin TTL for both mono and stereo variants."""
    out = [_PREFIXES]
    out.append("@prefix rdf: <http://www.w3.org/1999/02/22-rdf-syntax-ns#> .\n")
    for uri, n_chn, label in (
        (PLUGIN_URI, 1, "Phase Rotate (TPU) Mono"),
        (PLUGIN_URI_STEREO, 2, "Phase Rotate (TPU) Stereo"),
    ):
        ports = _fixed_ports()
        for c in range(n_chn):
            suffix = "" if n_chn == 1 else ("_L" if c == 0 else "_R")
            ports += _channel_ports(c, 3 + 3 * c, suffix)
        out.append(f"""
<{uri}>
	a lv2:Plugin, lv2:PhaserPlugin, doap:Project ;
	doap:license <http://usefulinc.com/doap/licenses/gpl> ;
	doap:name "{label}" ;
	lv2:requiredFeature urid:map ;
	lv2:minorVersion {version_minor} ;
	lv2:microVersion {version_micro} ;
{ports} .
""")
    return "".join(out)


UI_URI = PLUGIN_URI + "#web_ui"
X11_UI_URI = PLUGIN_URI + "#x11_ui"


def manifest_ttl(binary: str = "phaserotate_tpu.so",
                 ui_binary: str = "prt_ui.so",
                 x11_ui_binary: str = "prt_xui.so") -> str:
    """Bundle manifest (lv2ttl/manifest.ttl.in + manifest.gui.in
    equivalent): both plugin URIs plus TWO LV2UI entries — the embedded
    X11 surface (native/prt_xui.cc, the in-process equivalent of the
    reference's robtk GL UI, gui/phaserotate.c:1136-1309) listed first
    so hosts prefer it, and the browser-GUI launcher (native/prt_ui.cc;
    ui:showInterface surface served by gui/web.py) as fallback."""
    lines = [
        "@prefix lv2:  <http://lv2plug.in/ns/lv2core#> .",
        "@prefix rdfs: <http://www.w3.org/2000/01/rdf-schema#> .",
        "@prefix ui:   <http://lv2plug.in/ns/extensions/ui#> .",
        "@prefix urid: <http://lv2plug.in/ns/ext/urid#> .",
        "",
    ]
    for uri in (PLUGIN_URI, PLUGIN_URI_STEREO):
        lines += [
            f"<{uri}>",
            "\ta lv2:Plugin ;",
            f"\tlv2:binary <{binary}> ;",
            f"\tui:ui <{X11_UI_URI}> , <{UI_URI}> ;",
            "\trdfs:seeAlso <phaserotate_tpu.ttl> .",
            "",
        ]
    lines += [
        f"<{X11_UI_URI}>",
        "\ta ui:X11UI ;",
        f"\tui:binary <{x11_ui_binary}> ;",
        "\tlv2:requiredFeature urid:map ;",
        "\tlv2:optionalFeature ui:parent ;",
        "\tlv2:extensionData ui:idleInterface, ui:showInterface .",
        "",
        f"<{UI_URI}>",
        "\ta ui:UI ;",
        f"\tui:binary <{ui_binary}> ;",
        "\tlv2:extensionData ui:showInterface, ui:idleInterface .",
        "",
    ]
    return "\n".join(lines)


def write_bundle(directory: str) -> None:
    """Write a loadable LV2 bundle: manifest.ttl, phaserotate_tpu.ttl and
    the binaries it references: ``phaserotate_tpu.so`` (the native
    engine-socket shim, native/prt_lv2.cc), ``prt_xui.so`` (the embedded
    X11 LV2UI, native/prt_xui.cc) and ``prt_ui.so`` (the browser-GUI
    LV2UI launcher, native/prt_ui.cc) — the manifest must never point at
    a binary that does not exist."""
    import os
    import shutil
    import subprocess

    # resolve the binary FIRST: an honest bundle must not reference a
    # ghost, and a failure must not leave a half-written directory
    native_dir = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "native")
    sos = [os.path.join(native_dir, b)
           for b in ("phaserotate_tpu.so", "prt_ui.so", "prt_xui.so")]
    if not all(os.path.exists(s) for s in sos):
        try:
            subprocess.run(
                ["make", "-C", native_dir, "phaserotate_tpu.so",
                 "prt_ui.so", "prt_xui.so"],
                check=True, capture_output=True, timeout=120)
        except Exception:
            pass
    for s in sos:
        if not os.path.exists(s):
            raise RuntimeError(
                f"{os.path.basename(s)} missing and could not be built "
                f"(looked in {native_dir}); run `make -C native` first")

    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "manifest.ttl"), "w") as f:
        f.write(manifest_ttl())
    with open(os.path.join(directory, "phaserotate_tpu.ttl"), "w") as f:
        f.write(plugin_ttl())
    for s in sos:
        shutil.copy2(s, os.path.join(directory, os.path.basename(s)))
