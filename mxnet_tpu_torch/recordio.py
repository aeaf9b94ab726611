"""RecordIO: the reference's packed binary record format (counterpart
of ``mxnet_tpu/recordio.py``; reference: python/mxnet/recordio.py).

Byte for byte the JAX package's format in both directions: magic
0xced7230a, a 4-byte length word (29-bit size, 3-bit continuation flag),
4-byte alignment, ``IRHeader`` structs, and the ``.idx`` text index of
``MXIndexedRecordIO``. Records are read by the Python parser (the JAX
package's optional native reader is not ported). ``pack_img`` /
``unpack_img`` import ``cv2`` when called.
"""
from __future__ import annotations

import numbers
import os
import struct
from collections import namedtuple

import numpy as np

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "unpack_img", "pack_img"]

_MAGIC = 0xced7230a
_LFLAG_BITS = 29


def _encode_lrec(cflag, length):
    return (cflag << _LFLAG_BITS) | length


def _decode_lrec(lrec):
    return lrec >> _LFLAG_BITS, lrec & ((1 << _LFLAG_BITS) - 1)


class MXRecordIO:
    """Sequential record reader/writer (reference: recordio.py:36)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.handle = None
        self.is_open = False
        self.open()

    def open(self):
        if self.flag == "w":
            self.handle = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.handle = open(self.uri, "rb")
            self.writable = False
        else:
            raise ValueError("Invalid flag %s" % self.flag)
        self.is_open = True

    def __del__(self):
        self.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __getstate__(self):
        """For pickling (multiprocess DataLoader workers)
        (reference: recordio.py:87)."""
        is_open = self.is_open
        self.close()
        d = dict(self.__dict__)
        d["is_open"] = is_open
        d["handle"] = None
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        is_open = d["is_open"]
        self.is_open = False
        if is_open:
            self.open()

    def close(self):
        if not self.is_open:
            return
        self.handle.close()
        self.is_open = False

    def reset(self):
        """(reference: recordio.py:122)"""
        if not self.writable and self.is_open:
            self.handle.seek(0)
            return
        self.close()
        self.open()

    _MAX_CHUNK = (1 << _LFLAG_BITS) - 1

    def _write_chunk(self, cflag, chunk):
        self.handle.write(struct.pack("<II", _MAGIC,
                                      _encode_lrec(cflag, len(chunk))))
        self.handle.write(chunk)
        pad = (4 - len(chunk) % 4) % 4
        if pad:
            self.handle.write(b"\x00" * pad)

    def write(self, buf):
        """Write one record; records >= 2^29 bytes split into continuation
        chunks (dmlc-core recordio: cflag 0=whole 1=start 2=middle 3=end)."""
        assert self.writable
        if len(buf) <= self._MAX_CHUNK:
            self._write_chunk(0, buf)
            return
        chunks = [buf[i:i + self._MAX_CHUNK]
                  for i in range(0, len(buf), self._MAX_CHUNK)]
        for i, chunk in enumerate(chunks):
            cflag = 1 if i == 0 else (3 if i == len(chunks) - 1 else 2)
            self._write_chunk(cflag, chunk)

    def read(self):
        """Read one record, None at EOF (reference: recordio.py:150)."""
        assert not self.writable
        header = self.handle.read(8)
        if len(header) < 8:
            return None
        magic, lrec = struct.unpack("<II", header)
        if magic != _MAGIC:
            raise RuntimeError(f"invalid record magic {magic:#x} in "
                               f"{self.uri}")
        cflag, length = _decode_lrec(lrec)
        buf = self.handle.read(length)
        pad = (4 - length % 4) % 4
        if pad:
            self.handle.read(pad)
        if cflag == 1:
            # multi-part record: read middle (2) chunks until the end (3)
            parts = [buf]
            while cflag != 3:
                header = self.handle.read(8)
                magic, lrec = struct.unpack("<II", header)
                if magic != _MAGIC:
                    raise RuntimeError("corrupt continuation record in "
                                       f"{self.uri}")
                cflag, length = _decode_lrec(lrec)
                part = self.handle.read(length)
                pad = (4 - length % 4) % 4
                if pad:
                    self.handle.read(pad)
                parts.append(part)
            buf = b"".join(parts)
        return buf

    def tell(self):
        return self.handle.tell()


class MXIndexedRecordIO(MXRecordIO):
    """Random-access records via a .idx file (reference: recordio.py:180)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if not self.writable and os.path.isfile(self.idx_path):
            with open(self.idx_path) as fin:
                for line in fin:
                    parts = line.strip().split("\t")
                    if len(parts) < 2:
                        continue
                    key = self.key_type(parts[0])
                    self.idx[key] = int(parts[1])
                    self.keys.append(key)

    def close(self):
        if not self.is_open:
            return
        if self.writable:
            with open(self.idx_path, "w") as fout:
                for k in self.keys:
                    fout.write(f"{k}\t{self.idx[k]}\n")
        super().close()

    def seek(self, idx):
        """(reference: recordio.py:230)"""
        assert not self.writable
        pos = self.idx[idx]
        self.handle.seek(pos)

    def read_idx(self, idx):
        """(reference: recordio.py:247)"""
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        """(reference: recordio.py:258)"""
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.idx[key] = pos
        self.keys.append(key)


# header: flag (uint32), label (float32 or count), id (uint64), id2 (uint64)
IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """Pack a header + bytes into a record payload
    (reference: recordio.py:289)."""
    header = IRHeader(*header)
    if isinstance(header.label, numbers.Number):
        header = header._replace(flag=0)
    else:
        label = np.asarray(header.label, dtype=np.float32)
        header = header._replace(flag=label.size, label=0)
        s = label.tobytes() + s
    return struct.pack(_IR_FORMAT, *header) + s


def unpack(s):
    """(reference: recordio.py:316)"""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(s[:header.flag * 4], np.float32).copy()
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def unpack_img(s, iscolor=-1):
    """(reference: recordio.py:336)"""
    import cv2
    header, s = unpack(s)
    img = np.frombuffer(s, dtype=np.uint8)
    img = cv2.imdecode(img, iscolor)
    return header, img


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """(reference: recordio.py:360)"""
    import cv2
    encode_params = None
    if img_fmt.lower() in (".jpg", ".jpeg"):
        encode_params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    elif img_fmt.lower() == ".png":
        encode_params = [cv2.IMWRITE_PNG_COMPRESSION, quality]
    ret, buf = cv2.imencode(img_fmt, img, encode_params)
    assert ret, "failed to encode image"
    return pack(header, buf.tobytes())
