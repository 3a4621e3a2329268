"""ctypes bindings for the repository's C++ host-path code (counterpart of
tell_tpu/data/native.py): the byte-BPE encoder of native/bpe.cpp and the
.npz shard reader and batch gather of native/npz.cpp, over the same C ABI
(tnt_bpe_*, tnt_npz_*).

The library is compiled from native/*.cpp with the host g++ (the flags of
native/Makefile) into tell_tpu_torch/build/ (listed in .gitignore), under
a name keyed on a hash of the sources and flags, at the first use, never
at import. native/libtnt_native.so is the JAX package's build and is never
read here. A failed build or load raises with the compiler's output; the
Python routes (ByteBPE, ShardReader, pack_batch's numpy path) are taken
only where the caller asks for them (use_native=False), and for one format
the C++ reader cannot map: a compressed .npz, read by ShardReader with a
log line.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
import zipfile
from pathlib import Path

import numpy as np

log = logging.getLogger("tell_tpu_torch.native")

_ROOT = Path(__file__).resolve().parents[2]
NATIVE_DIR = _ROOT / "native"
SOURCES = ("bpe.cpp", "npz.cpp")
HEADERS = ("unicode_tables.h",)
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")
BUILD_DIR = _ROOT / "tell_tpu_torch" / "build"

F32_NAN_BITS = 0x7FC00000

_lock = threading.Lock()
_libs: dict[Path, ctypes.CDLL] = {}


def shared_library_path(sources, flags, build_dir: Path, stem: str) -> Path:
    """<build_dir>/<stem>_<hash>.so, the hash over the flags and the files'
    names and bytes."""
    h = hashlib.sha256(" ".join(flags).encode())
    for path in sources:
        h.update(Path(path).name.encode())
        h.update(Path(path).read_bytes())
    return Path(build_dir) / f"{stem}_{h.hexdigest()[:16]}.so"


def compile_shared(sources, headers, flags, build_dir: Path,
                   stem: str) -> Path:
    """Compile `sources` with g++ into a shared library unless the one for
    these files and flags exists in build_dir; written to a temporary name
    and renamed into place, so processes that build at once never load a
    half-written file. A failed build raises with the compiler's output."""
    out = shared_library_path([*sources, *headers], flags, build_dir, stem)
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: {stem} is compiled from "
                           + ", ".join(Path(s).name for s in sources))
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [cxx, *flags, "-o", str(tmp), *(str(s) for s in sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def library_path(build_dir: Path = BUILD_DIR) -> Path:
    """The build's output path for the current sources and flags."""
    return shared_library_path(
        [NATIVE_DIR / n for n in SOURCES + HEADERS], CXX_FLAGS, build_dir,
        "libtnt_host")


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compile native/*.cpp unless the library for these sources exists in
    build_dir."""
    return compile_shared([NATIVE_DIR / n for n in SOURCES],
                          [NATIVE_DIR / n for n in HEADERS], CXX_FLAGS,
                          build_dir, "libtnt_host")


def _bind(lib: ctypes.CDLL) -> None:
    P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    i32p, cp = ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p
    sigs = {
        "tnt_bpe_new": (P, [cp, i32p, I, cp, I, I]),
        "tnt_bpe_free": (None, [P]),
        "tnt_bpe_encode": (I, [P, cp, i32p, I]),
        "tnt_npz_open": (P, [cp]),
        "tnt_npz_close": (None, [P]),
        "tnt_npz_count": (I, [P]),
        "tnt_npz_name": (I, [P, I, cp, I]),
        "tnt_npz_info": (I, [P, I, cp, I, ctypes.POINTER(I64), I]),
        "tnt_npz_read": (I64, [P, I, P]),
        "tnt_npz_read_multi": (I64, [P, i32p, ctypes.POINTER(P), I]),
        "tnt_npz_gather_pad": (I64, [ctypes.POINTER(P), i32p, I, P, I64, I,
                                     ctypes.c_uint32, I]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


def load_library(build_dir: Path = BUILD_DIR) -> ctypes.CDLL:
    """Build (first call only) and load the host library; raises on
    failure."""
    build_dir = Path(build_dir)
    with _lock:
        lib = _libs.get(build_dir)
        if lib is None:
            lib = ctypes.CDLL(str(build(build_dir)))
            _bind(lib)
            _libs[build_dir] = lib
    return lib


class NativeBPE:
    """encode() through the C++ core; decode() and the per-piece helpers
    through the Python ByteBPE twin (decoding runs once per caption, not
    per corpus)."""

    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]],
                 lib: ctypes.CDLL | None = None):
        from .tokenizer import ByteBPE
        self._lib = lib or load_library()
        tokens = list(vocab)
        ids = np.asarray([vocab[t] for t in tokens], np.int32)
        blob = "\n".join(tokens).encode("utf-8")
        mblob = "\n".join(f"{a} {b}" for a, b in merges).encode("utf-8")
        self._h = self._lib.tnt_bpe_new(
            blob, ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(tokens), mblob, len(merges), vocab.get("<unk>", 3))
        if not self._h:
            raise RuntimeError("native BPE construction failed")
        self._py = ByteBPE(vocab, merges)
        for name in ("encoder", "decoder", "ranks", "byte_encoder",
                     "byte_decoder"):
            setattr(self, name, getattr(self._py, name))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.tnt_bpe_free(self._h)
            self._h = None

    def encode(self, text: str) -> list[int]:
        data = text.encode("utf-8")
        if b"\x00" in data:
            # the C API takes a NUL-terminated string; the Python twin
            # byte-maps NUL like any other byte
            return self._py.encode(text)
        cap = max(4 * len(data) + 16, 64)
        out = np.empty((cap,), np.int32)
        n = self._lib.tnt_bpe_encode(
            self._h, data, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            cap)
        if n < 0:
            raise RuntimeError("native BPE encode overflowed its buffer")
        return out[:n].tolist()

    def decode(self, ids) -> str:
        return self._py.decode(ids)

    def _bpe(self, token: str) -> list[str]:
        return self._py._bpe(token)

    def _piece_ids(self, chunk: str, unk: int) -> list[int]:
        return self._py._piece_ids(chunk, unk)


class NativeShardReader:
    """records.ShardReader's surface over native/npz.cpp: the shard is
    mmapped once, the zip directory and each member's .npy header are
    parsed at open, and a field read is one memcpy out of the mapping (so
    what it returns stays valid after the handle closes)."""

    native = True        # native.gather_pad reads its mapping

    def __init__(self, path: str):
        self._lib = load_library()
        self.path = path
        self._h = None
        self.open()
        try:
            n = self._lib.tnt_npz_count(self._h)
            namebuf = ctypes.create_string_buffer(512)
            dbuf = ctypes.create_string_buffer(64)
            shape = (ctypes.c_int64 * 8)()
            # (example, field) -> (member index, dtype, shape)
            self._members: dict[tuple[int, str],
                                tuple[int, np.dtype, tuple]] = {}
            self._fields: dict[int, list[str]] = {}
            self._len = 0
            for i in range(n):
                if self._lib.tnt_npz_name(self._h, i, namebuf, 512) < 0:
                    raise RuntimeError(f"member name overflow in {path}")
                name = namebuf.value.decode("utf-8")
                ndim = self._lib.tnt_npz_info(self._h, i, dbuf, 64, shape, 8)
                if ndim < 0:
                    raise RuntimeError(f"bad member {name} in {path}")
                dt = np.dtype(dbuf.value.decode("ascii"))
                shp = tuple(shape[d] for d in range(ndim))
                if name == "__len__":
                    buf = np.empty(shp, dt)
                    self._read_into(i, buf)
                    self._len = int(buf)
                    continue
                idx, field = name.split("/", 1)
                self._members[(int(idx), field)] = (i, dt, shp)
                self._fields.setdefault(int(idx), []).append(field)
        except Exception:
            self.close()
            raise

    def _read_into(self, i: int, arr: np.ndarray) -> None:
        got = self._lib.tnt_npz_read(self._h, i,
                                     arr.ctypes.data_as(ctypes.c_void_p))
        if got != arr.nbytes:
            raise RuntimeError(
                f"short read on {self.path}[{i}]: {got} != {arr.nbytes}")

    def open(self) -> None:
        if self._h is None:
            h = self._lib.tnt_npz_open(self.path.encode("utf-8"))
            if not h:
                raise RuntimeError(f"native npz open failed: {self.path}")
            self._h = h

    def close(self) -> None:
        if self._h is not None:
            self._lib.tnt_npz_close(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None) is not None:
            self.close()

    def __len__(self) -> int:
        return self._len

    def __getitem__(self, i: int) -> dict:
        """Every field of example i, in one FFI call."""
        self.open()
        fields = self._fields.get(i, [])
        n = len(fields)
        arrs = []
        idx = (ctypes.c_int32 * n)()
        ptrs = (ctypes.c_void_p * n)()
        for k, field in enumerate(fields):
            mi, dt, shp = self._members[(i, field)]
            arrs.append(np.empty(shp, dt))
            idx[k] = mi
            ptrs[k] = arrs[-1].ctypes.data
        expect = sum(a.nbytes for a in arrs)
        got = self._lib.tnt_npz_read_multi(self._h, idx, ptrs, n)
        if got != expect:
            raise RuntimeError(
                f"short read on {self.path}[{i}]: {got} != {expect}")
        return {f: _scalar_str(a) for f, a in zip(fields, arrs)}

    # the lazy-example surface: metadata without reading data

    def fields_of(self, i: int) -> list[str]:
        return self._fields.get(i, [])

    def field_shape(self, i: int, field: str) -> tuple | None:
        m = self._members.get((i, field))
        return m[2] if m is not None else None

    def field_dtype(self, i: int, field: str):
        m = self._members.get((i, field))
        return m[1] if m is not None else None

    def field_member(self, i: int, field: str):
        """(open mmap handle, member index) for the C++ gather; reopens a
        shard that the dataset's LRU closed."""
        m = self._members.get((i, field))
        if m is None:
            return None
        self.open()
        return self._h, m[0]

    def read_field(self, i: int, field: str):
        m = self._members.get((i, field))
        if m is None:
            raise KeyError(field)
        self.open()
        mi, dt, shp = m
        arr = np.empty(shp, dt)
        self._read_into(mi, arr)
        return _scalar_str(arr)


def _scalar_str(arr: np.ndarray):
    """A 0-d unicode member as str (as ShardReader returns it)."""
    return arr.item() if arr.dtype.kind == "U" and arr.ndim == 0 else arr


def gather_pad(examples: list, field: str, out: np.ndarray, pad: int,
               convert_f16: bool = False) -> None:
    """Fill the row-major batch buffer out [B, ...] with each example's
    `field` in one C++ call, cut or padded to out's row with the raw 4-byte
    pattern `pad` (PAD_ID, -1, F32_NAN_BITS); an example without the field
    gets an all-pad row. The examples are LazyExamples over
    NativeShardReaders. A member whose dtype or trailing shape does not
    match out's rows raises (the copy is of raw bytes)."""
    lib = load_library()
    n = len(examples)
    handles = (ctypes.c_void_p * n)()
    idx = (ctypes.c_int32 * n)()
    want = np.dtype(np.float16) if convert_f16 else out.dtype
    for k, ex in enumerate(examples):
        shp = ex.field_shape(field)
        if shp is None:
            handles[k], idx[k] = None, -1
            continue
        dt = ex.field_dtype(field)
        if dt != want or tuple(shp[1:]) != out.shape[2:]:
            raise ValueError(f"{field}: member {dt}{list(shp)} does not fit "
                             f"rows of {want}{list(out.shape[1:])}")
        handles[k], idx[k] = ex.field_member(field)
    row_elems = int(np.prod(out.shape[1:], dtype=np.int64))
    got = lib.tnt_npz_gather_pad(
        handles, idx, n, out.ctypes.data_as(ctypes.c_void_p), row_elems,
        out.dtype.itemsize, ctypes.c_uint32(pad & 0xFFFFFFFF),
        1 if convert_f16 else 0)
    if got < 0:
        raise RuntimeError(f"native gather failed for field {field}")


def _compressed(path: str) -> bool:
    """True when path is a zip with a deflated (or otherwise compressed)
    member: np.savez_compressed's format, which the C++ reader cannot
    map."""
    if not zipfile.is_zipfile(path):
        return False
    with zipfile.ZipFile(path) as z:
        return any(i.compress_type != zipfile.ZIP_STORED
                   for i in z.infolist())


def native_shard_reader(path: str, use_native: bool = True):
    """NativeShardReader, or the Python ShardReader where the caller asks
    for it (use_native=False) or the shard is a compressed .npz (logged).
    Anything else the C++ reader refuses raises."""
    from .records import ShardReader
    if not use_native:
        return ShardReader(path)
    try:
        return NativeShardReader(path)
    except RuntimeError:
        if not _compressed(path):
            raise
    log.info("%s is a compressed .npz, which the C++ reader cannot map: "
             "reading it with the Python ShardReader", path)
    return ShardReader(path)
