"""ctypes binding + lazy build of the native host library.

Builds ``src/mc_native.cpp`` with g++ on first use (cached next to the
source); degrades gracefully (``available = False``) when no compiler is
present, since every native component has a Python/JAX dual.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

__all__ = ["available", "build", "threefry2x32", "black_scholes_call",
           "cnd_as", "price_cpu", "fill_normals", "write_traj_csv",
           "DEFAULT_ROUNDS"]

# Mirror of mc_tpu.rng.DEFAULT_ROUNDS (kept as a literal here so this
# module stays importable before jax; tests pin the two equal).
DEFAULT_ROUNDS = 13

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src", "mc_native.cpp")
_SO = os.path.join(_DIR, "_mc_native.so")

_lock = threading.Lock()
_dll = None
available = False


def build(force: bool = False) -> bool:
    """Compile the shared library if needed. Returns success."""
    if (not force and os.path.exists(_SO)
            and os.path.getmtime(_SO) >= os.path.getmtime(_SRC)):
        return True
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
           _SRC, "-o", _SO]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except Exception:
        return False


def _load():
    global _dll, available
    with _lock:
        if _dll is not None:
            return _dll
        if not build():
            return None
        try:
            dll = ctypes.CDLL(_SO)
        except OSError:
            # stale/foreign-ABI binary (e.g. a copied .so): rebuild once
            if not build(force=True):
                return None
            dll = ctypes.CDLL(_SO)
        u32, u64, i32 = ctypes.c_uint32, ctypes.c_uint64, ctypes.c_int
        f64, f32p = ctypes.c_double, ctypes.POINTER(ctypes.c_float)
        dll.threefry2x32.argtypes = [u32, u32, u32, u32,
                                     ctypes.POINTER(u32), ctypes.POINTER(u32)]
        dll.threefry2x32_r.argtypes = [u32, u32, u32, u32, i32,
                                       ctypes.POINTER(u32),
                                       ctypes.POINTER(u32)]
        dll.black_scholes_call.restype = f64
        dll.black_scholes_call.argtypes = [f64] * 5 + [i32]
        dll.cnd_as.restype = f64
        dll.cnd_as.argtypes = [f64]
        dll.price_cpu.restype = f64
        dll.price_cpu.argtypes = [i32, u32, u32, u64, i32,
                                  ctypes.c_float, ctypes.c_float,
                                  ctypes.c_float, ctypes.c_float,
                                  ctypes.c_float, ctypes.c_float,
                                  ctypes.c_float, ctypes.c_float,
                                  ctypes.c_float, i32, i32,
                                  ctypes.POINTER(f64)]
        dll.fill_normals.argtypes = [u32, u32, u32, u64, i32, f32p]
        dll.write_traj_csv.restype = i32
        dll.write_traj_csv.argtypes = [ctypes.c_char_p, f32p, u64, u64]
        _dll = dll
        available = True
        return dll


def threefry2x32(k0: int, k1: int, x0: int, x1: int):
    dll = _load()
    a = ctypes.c_uint32()
    b = ctypes.c_uint32()
    dll.threefry2x32(k0, k1, x0, x1, ctypes.byref(a), ctypes.byref(b))
    return a.value, b.value


def black_scholes_call(s0, k, t, r, sigma, exact=True) -> float:
    return _load().black_scholes_call(s0, k, t, r, sigma, int(exact))


def cnd_as(x) -> float:
    return _load().cnd_as(x)


def price_cpu(payoff: str, key, n_paths: int, n_steps: int, *, s0=100.0,
              k=100.0, r=0.1, sigma=0.2, t=1.0, barrier=120.0, p1=10.0,
              p2=50.0, q=0.0, rounds=DEFAULT_ROUNDS, n_threads=0):
    """Multithreaded native CPU pricer on the framework's threefry stream.

    The C5 equivalent (tool.cuh:104-173): payoff 'vanilla_call' uses the
    exact terminal draw; 'bullet_call' the full log-Euler loop;
    'vanilla_call_pair' mirrors the method="terminal_pair" stream
    (element e carries paths (2e, 2e+1) — pass the PATH count, it is
    halved here).  Returns (price, stderr).
    """
    kind = {"vanilla_call": 0, "bullet_call": 1,
            "vanilla_call_pair": 2}[payoff]
    n_iter = (n_paths + 1) // 2 if kind == 2 else n_paths
    se = ctypes.c_double()
    price = _load().price_cpu(kind, int(key[0]), int(key[1]), n_iter,
                              n_steps, s0, k, r, sigma, t, barrier, p1, p2,
                              q, rounds, n_threads, ctypes.byref(se))
    return price, se.value


def fill_normals(key, j: int, n: int,
                 rounds: int = DEFAULT_ROUNDS) -> np.ndarray:
    out = np.empty(n, np.float32)
    _load().fill_normals(int(key[0]), int(key[1]), j, n, rounds,
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def write_traj_csv(path: str, mat: np.ndarray) -> None:
    mat = np.ascontiguousarray(mat, np.float32)
    n_paths, n_steps = mat.shape
    rc = _load().write_traj_csv(
        path.encode(), mat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n_paths, n_steps)
    if rc != 0:
        raise OSError(f"write_traj_csv failed for {path}")


# Probe availability eagerly but cheaply (no exception on failure).
try:
    available = _load() is not None
except Exception:
    available = False
