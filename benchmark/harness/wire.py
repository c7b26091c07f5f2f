"""The engine daemon's wire protocol, as native/prt_protocol.h states it:
little-endian, an 8-byte header ``u32 type, u32 len`` and its payload.

    INIT  (1): u32 rate, u32 channels -> INIT_OK (101): u32 latency,
               u32 parsiz, u32 channels
    PROC  (2): u32 n, f32 angle_deg[channels], f32 samples[n*channels]
               (interleaved) -> PROC_OK (102): u32 n, f32 samples[n*ch]
    BYE   (3)
    LEVELS (103), before the PROC_OK it belongs to: u32 count, then per
               entry u32 channel and 9 f32 levels
    STATE (104): informational; ERR (199): utf-8 text, then close.
    Replies 103..198 are informational: a client skips what it does not
    read."""

from __future__ import annotations

import socket
import struct

MAGIC = 0x50525431  # "PRT1"
INIT, PROC, BYE = 1, 2, 3
INIT_OK, PROC_OK, LEVELS, STATE, ERR = 101, 102, 103, 104, 199
INFO_FIRST, INFO_LAST = 103, 198


class Conn:
    """One client connection with a buffered reader."""

    def __init__(self, path: str):
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.connect(path)
        self.buf = bytearray()
        self.sock.sendall(struct.pack("<I", MAGIC))

    def send(self, mtype: int, payload: bytes = b"") -> None:
        self.sock.sendall(struct.pack("<II", mtype, len(payload)) + payload)

    def _fill(self, n: int) -> None:
        while len(self.buf) < n:
            chunk = self.sock.recv(max(1 << 16, n - len(self.buf)))
            if not chunk:
                raise ConnectionError("daemon closed the connection")
            self.buf += chunk

    def recv(self):
        self._fill(8)
        mtype, n = struct.unpack_from("<II", self.buf, 0)
        self._fill(8 + n)
        payload = bytes(self.buf[8 : 8 + n])
        del self.buf[: 8 + n]
        return mtype, payload

    def close(self) -> None:
        try:
            self.send(BYE)
        except OSError:
            pass
        self.sock.close()
