"""Minimal ID3v2.3/2.4 tag reading, editing, and writing.

Replaces the reference's ``id3`` crate usage (SURVEY.md §2.2): tags read
from DSF (metadata pointer) / DFF ('ID3 ' chunk) are copied into output
files, with graceful degradation on truncated/broken tags (fixtures
id3_test/1kHz_mono_brokenid3.dsf and
id3_test/dff/1kHz_stereo_i_brokenid3.dff encode the required tolerance),
and the album tag gets a " [<OUTPUT_RATE>]" suffix under -a
(reference: src/main.rs:121-124).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Optional


def _syncsafe_decode(b: bytes) -> int:
    return (b[0] << 21) | (b[1] << 14) | (b[2] << 7) | b[3]


def _syncsafe_encode(n: int) -> bytes:
    return bytes([(n >> 21) & 0x7F, (n >> 14) & 0x7F, (n >> 7) & 0x7F, n & 0x7F])


@dataclass
class Id3Frame:
    frame_id: str
    data: bytes
    flags: int = 0

    def text(self) -> Optional[str]:
        """Decode a text frame's payload, or None for non-text frames."""
        if not self.frame_id.startswith("T") or not self.data:
            return None
        enc = self.data[0]
        raw = self.data[1:]
        try:
            if enc == 0:
                return raw.decode("latin-1").rstrip("\x00")
            if enc == 1:
                return raw.decode("utf-16").rstrip("\x00")
            if enc == 2:
                return raw.decode("utf-16-be").rstrip("\x00")
            if enc == 3:
                return raw.decode("utf-8").rstrip("\x00")
        except UnicodeDecodeError:
            return raw.decode("latin-1", "replace").rstrip("\x00")
        return None

    @classmethod
    def text_frame(cls, frame_id: str, value: str) -> "Id3Frame":
        return cls(frame_id, b"\x03" + value.encode("utf-8"))


@dataclass
class Id3Tag:
    version: tuple[int, int] = (3, 0)  # (major, revision); v2.<major>.<rev>
    frames: list[Id3Frame] = field(default_factory=list)
    truncated: bool = False  # tag was cut short in the source file

    def get_text(self, frame_id: str) -> Optional[str]:
        for fr in self.frames:
            if fr.frame_id == frame_id:
                return fr.text()
        return None

    def set_text(self, frame_id: str, value: str) -> None:
        for i, fr in enumerate(self.frames):
            if fr.frame_id == frame_id:
                self.frames[i] = Id3Frame.text_frame(frame_id, value)
                return
        self.frames.append(Id3Frame.text_frame(frame_id, value))

    def append_to_album(self, suffix: str) -> None:
        """-a behavior: append " [<OUTPUT_RATE>]" to the album tag if present
        (reference: src/main.rs:121-124)."""
        album = self.get_text("TALB")
        if album is not None:
            self.set_text("TALB", album + suffix)

    # -- serialization ------------------------------------------------------

    def to_bytes(self) -> bytes:
        major = 4 if self.version[0] >= 4 else 3
        body = b""
        for fr in self.frames:
            data = fr.data
            if (major == 3 and fr.frame_id.startswith("T")
                    and data[:1] == b"\x03"):
                # encoding 3 (UTF-8) is defined only in v2.4; our
                # text_frame always builds UTF-8, so re-encode when the
                # tag serializes as v2.3 (latin-1 when it fits, else
                # UTF-16 with BOM) — strict v2.3 readers reject enc 3
                txt = fr.text() or ""
                try:
                    data = b"\x00" + txt.encode("latin-1")
                except UnicodeEncodeError:
                    data = b"\x01" + txt.encode("utf-16")
            if major == 4:
                size = _syncsafe_encode(len(data))
            else:
                size = struct.pack(">I", len(data))
            body += fr.frame_id.encode("latin-1")[:4].ljust(4, b"\x00")
            body += size + struct.pack(">H", fr.flags) + data
        header = b"ID3" + bytes([major, 0, 0]) + _syncsafe_encode(len(body))
        return header + body


def parse_id3(blob: bytes) -> Optional[Id3Tag]:
    """Parse an ID3v2 tag, tolerating truncation: every fully-present frame
    is kept, a frame cut mid-payload is dropped, and the tag is flagged
    ``truncated`` (behavior required by the broken fixtures, SURVEY.md §4.2).
    """
    if len(blob) < 10 or blob[:3] != b"ID3":
        return None
    major, _rev = blob[3], blob[4]
    flags = blob[5]
    declared = _syncsafe_decode(blob[6:10])
    tag = Id3Tag(version=(major, _rev))
    body = blob[10:10 + declared]
    if len(body) < declared:
        tag.truncated = True
    # Tag-level unsynchronisation (flag 0x80): v2.2/v2.3 stuff a 0x00
    # after every 0xFF over the WHOLE tag body (frame sizes refer to the
    # de-unsynced data), so undo it before the frame loop — otherwise
    # payloads keep the stuffed bytes (corrupt APIC) and non-syncsafe
    # sizes desync the loop, silently dropping the rest of the tag. In
    # v2.4 the same flag means every frame was unsynced individually;
    # that is handled per-frame below (stored sizes count stored bytes).
    if flags & 0x80 and major <= 3:
        body = body.replace(b"\xff\x00", b"\xff")
    off = 0
    # Flag bit 0x40: v2.3/2.4 extended header (skip it); in v2.2 the same
    # bit means whole-tag COMPRESSION, which the spec says to ignore
    # entirely (there is no defined scheme) — return the empty tag rather
    # than misreading frame bytes as an extended-header length.
    if flags & 0x40:
        if major == 2:
            return tag
        if len(body) >= 4:
            if major >= 4:
                ext = _syncsafe_decode(body[0:4])
            else:
                (ext,) = struct.unpack(">I", body[0:4])
                ext += 4
            off = min(ext, len(body))
    if major == 2:
        # ID3v2.2: 3-char frame IDs, 3-byte sizes, no frame flags. Frames
        # are upgraded to their v2.3 IDs so the rest of the pipeline (and
        # tag re-serialization into outputs) sees one dialect; frames with
        # no v2.3 mapping are dropped (an invented 4-char ID would abort
        # other parsers' frame loops and truncate the re-serialized tag).
        while off + 6 <= len(body):
            fid = body[off:off + 3]
            if fid == b"\x00\x00\x00":
                break  # padding
            try:
                fid_s = fid.decode("latin-1")
            except UnicodeDecodeError:
                break
            if not all(("A" <= c <= "Z") or ("0" <= c <= "9")
                       for c in fid_s):
                break
            size = (body[off + 3] << 16) | (body[off + 4] << 8) | body[off + 5]
            data = body[off + 6:off + 6 + size]
            if len(data) < size:
                tag.truncated = True
                break
            mapped = _V22_IDS.get(fid_s)
            if mapped == "APIC":
                data = _pic_to_apic(data)
            if mapped is not None and data is not None:
                tag.frames.append(Id3Frame(mapped, data))
            off += 6 + size
        return tag
    while off + 10 <= len(body):
        fid = body[off:off + 4]
        if fid == b"\x00\x00\x00\x00":
            break  # padding
        try:
            fid_s = fid.decode("latin-1")
        except UnicodeDecodeError:
            break
        if not all(("A" <= c <= "Z") or ("0" <= c <= "9") for c in fid_s):
            break
        if major >= 4:
            size = _syncsafe_decode(body[off + 4:off + 8])
        else:
            (size,) = struct.unpack(">I", body[off + 4:off + 8])
        (fflags,) = struct.unpack(">H", body[off + 8:off + 10])
        data = body[off + 10:off + 10 + size]
        if len(data) < size:
            tag.truncated = True
            break  # frame cut mid-payload: drop it, keep what we have
        if major >= 4:
            # v2.4 format flags: 0x01 = a 4-byte syncsafe data-length
            # indicator precedes the payload; 0x02 = the payload is
            # unsynchronised. Undo both and clear the bits so the
            # re-serialized tag (v2.3 dialect, no unsync) stays honest.
            if fflags & 0x01 and len(data) >= 4:
                data = data[4:]
            if fflags & 0x02 or flags & 0x80:
                data = data.replace(b"\xff\x00", b"\xff")
            fflags &= ~0x03
        tag.frames.append(Id3Frame(fid_s, data, fflags))
        off += 10 + size
    return tag


def _pic_to_apic(data: bytes) -> Optional[bytes]:
    """Convert a v2.2 PIC body (enc, 3-char image format, type, desc\\0,
    image) to the v2.3 APIC layout (enc, MIME\\0, type, desc\\0, image)."""
    if len(data) < 5:
        return None
    enc = data[0:1]
    fmt = data[1:4].decode("latin-1", "replace").strip("\x00").upper()
    known = {"JPG": "image/jpeg", "PNG": "image/png",
             "GIF": "image/gif", "BMP": "image/bmp"}
    # Unknown/blank format fields get a generic MIME: "image/" (empty
    # subtype) or an invented "image/xxx" is malformed and some tag
    # readers reject the whole APIC frame (advisor finding, round 2).
    mime = known.get(fmt, "application/octet-stream")
    return enc + mime.encode("latin-1") + b"\x00" + data[4:]


# v2.2 (3-char) -> v2.3 (4-char) frame IDs for the frames the pipeline
# touches; v2.2 frames with no mapping are dropped at parse time.
_V22_IDS = {
    "TT2": "TIT2", "TP1": "TPE1", "TAL": "TALB", "TRK": "TRCK",
    "TYE": "TYER", "TCO": "TCON", "TP2": "TPE2", "TCM": "TCOM",
    "TPA": "TPOS", "COM": "COMM", "PIC": "APIC", "TT1": "TIT1",
    "TT3": "TIT3", "TP3": "TPE3", "TBP": "TBPM", "TEN": "TENC",
}


@dataclass
class ApicPicture:
    """A decoded APIC frame: what FLAC's PICTURE metadata block carries
    (the reference copies tags "where possible" — README.md:7 — and
    embedded art is part of the tag)."""

    pic_type: int   # ID3 picture type == FLAC picture type (same registry)
    mime: str
    description: str
    data: bytes


def apic_pictures(tag: Id3Tag) -> list[ApicPicture]:
    """Decode every APIC frame in the tag (v2.2 PIC frames were already
    rewritten to APIC layout at parse time)."""
    out = []
    for fr in tag.frames:
        if fr.frame_id != "APIC":
            continue
        d = fr.data
        if len(d) < 4:
            continue
        enc = d[0]
        mime_end = d.find(b"\x00", 1)
        if mime_end < 0:
            continue
        mime = d[1:mime_end].decode("latin-1", "replace")
        p = mime_end + 1
        if p >= len(d):
            continue
        pic_type = d[p]
        p += 1
        # description terminator: \0 for latin-1/utf-8, \0\0 for UTF-16
        if enc in (1, 2):
            q = p
            while q + 1 < len(d) and d[q:q + 2] != b"\x00\x00":
                q += 2
            raw_desc, p = d[p:q], min(q + 2, len(d))
            codec = "utf-16" if enc == 1 else "utf-16-be"
        else:
            q = d.find(b"\x00", p)
            if q < 0:
                q = len(d)
            raw_desc, p = d[p:q], min(q + 1, len(d))
            codec = "latin-1" if enc == 0 else "utf-8"
        try:
            desc = raw_desc.decode(codec)
        except UnicodeDecodeError:
            desc = raw_desc.decode("latin-1", "replace")
        out.append(ApicPicture(pic_type, mime, desc, d[p:]))
    return out


def id3_to_vorbis_comments(tag: Id3Tag) -> list[tuple[str, str]]:
    """Map common ID3 text frames to FLAC vorbis-comment fields."""
    mapping = {
        "TIT2": "TITLE",
        "TPE1": "ARTIST",
        "TALB": "ALBUM",
        "TDRC": "DATE",
        "TYER": "DATE",
        "TRCK": "TRACKNUMBER",
        "TCON": "GENRE",
        "TPE2": "ALBUMARTIST",
        "TCOM": "COMPOSER",
        "TPOS": "DISCNUMBER",
    }
    out = []
    has_tdrc = any(fr.frame_id == "TDRC" for fr in tag.frames)
    for fr in tag.frames:
        # tags upgraded v2.3->v2.4 often carry TYER alongside TDRC;
        # emitting both would duplicate DATE (players may show the
        # legacy year) — the full TDRC timestamp wins
        if fr.frame_id == "TYER" and has_tdrc:
            continue
        name = mapping.get(fr.frame_id)
        if name is None:
            continue
        val = fr.text()
        if val:
            out.append((name, val))
    return out
