"""Wire protocol for the multi-host render farm.

The port's copy of the JAX package's `parallel/protocol.py`; the wire
format is the same, so either package's workers can serve either's
coordinator. Functional parity with the reference's two-plane design (SURVEY.md §5.8):
WebSocket JSON signaling + WebRTC chunked bulk transfer become one TCP
stream with metadata-then-bulk framing:

    header  : u32 json_len, u32 bin_len  (little endian)
    payload : json_len bytes of UTF-8 JSON + bin_len bytes of binary

Characteristics preserved: receiver preallocation from the announced length,
per-peer ordering (TCP), explicit message types, 64 KB-class control
messages with separate bulk payloads (scene bytes, encoded frames).

Message types mirror src/network/Protocol.ts:64-104 + signaling messages.
"""

from __future__ import annotations

import json
import socket
import struct
from dataclasses import dataclass
from typing import Optional

_HEADER = struct.Struct("<II")
MAX_JSON = 1 << 20
MAX_BIN = 1 << 31

# Control message types
HELLO = "hello"                 # worker -> coordinator (auth + resume)
WELCOME = "welcome"             # coordinator -> worker (session grant)
REJECT = "reject"
SCENE = "scene"                 # + bulk: obj text / glb bytes
SCENE_LOADED = "scene_loaded"
NEED_SCENE = "need_scene"
RENDER_REQUEST = "render_request"
RENDER_RESULT = "render_result"  # + bulk: concatenated encoded frames
WORKER_STATUS = "worker_status"
STOP_RENDER = "stop_render"
KICK = "kick"
ADMIN_STATUS = "admin_status"
ADMIN_STATUS_REPLY = "admin_status_reply"
PING = "ping"
PONG = "pong"


@dataclass
class Message:
    type: str
    body: dict
    payload: bytes = b""


def send_message(sock: socket.socket, msg: Message) -> None:
    data = json.dumps({"type": msg.type, **msg.body}).encode()
    header = _HEADER.pack(len(data), len(msg.payload))
    sock.sendall(header + data + msg.payload)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf.extend(chunk)
    return bytes(buf)


def recv_message(sock: socket.socket) -> Optional[Message]:
    header = _recv_exact(sock, _HEADER.size)
    if header is None:
        return None
    json_len, bin_len = _HEADER.unpack(header)
    if json_len > MAX_JSON or bin_len > MAX_BIN:
        return None
    data = _recv_exact(sock, json_len)
    if data is None:
        return None
    payload = _recv_exact(sock, bin_len) if bin_len else b""
    if bin_len and payload is None:
        return None
    obj = json.loads(data)
    t = obj.pop("type", "")
    return Message(type=t, body=obj, payload=payload)


def pack_frames(frames) -> tuple[list, bytes]:
    """Serialize EncodedFrames: metadata list + concatenated bytes
    (the reference's chunk-metadata + concatenated-chunk-bytes layout,
    RtcClient.ts:153-199)."""
    meta = []
    blob = bytearray()
    for f in frames:
        meta.append({
            "frame_index": f.frame_index,
            "timestamp_us": f.timestamp_us,
            "key_frame": f.key_frame,
            "size": len(f.data),
        })
        blob.extend(f.data)
    return meta, bytes(blob)


def unpack_frames(meta: list, blob: bytes):
    from ..render.recorder import EncodedFrame

    out = []
    off = 0
    for m in meta:
        size = int(m["size"])
        out.append(EncodedFrame(
            frame_index=int(m["frame_index"]),
            timestamp_us=int(m["timestamp_us"]),
            key_frame=bool(m["key_frame"]),
            data=blob[off:off + size],
        ))
        off += size
    return out
