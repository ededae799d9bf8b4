"""The Hopper kernels' rule itself, on the CPU: ``csrc/belief_merge.cuh``
compiled with the host's C++ compiler and called through ctypes.

The header's word form (four belief bytes to a 32-bit word, as the
kernels run it) is held against its byte form, and the byte form against
the plain torch version ``fused.merge_ref``: exhaustively over one pin
(current byte, pin byte, sender, receiver, cap, budget), and on random
words at fanouts 3 and 8.  Needs ``g++``; builds into the test's
temporary directory.
"""

import ctypes
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

from consul_tpu_torch import _build
from consul_tpu_torch.gossip import fused

RULE_SRC = r"""
#include <algorithm>
#include <cstdint>
#define __device__
#define __forceinline__ inline
using std::max;
using std::min;
#include "belief_merge.cuh"

// Byte form, as the kernels' ragged edges run it: n bytes, F pins each
// (pins and live are [F, n]), one cap per byte.
extern "C" void run_bytes(long n, int F, const uint8_t* cur,
                          const uint8_t* pins, const uint8_t* live,
                          const uint8_t* rx, const int32_t* cap, int budget,
                          uint8_t* out) {
  for (long i = 0; i < n; ++i) {
    int in_msg = 0, n_sus = 0;
    for (int f = 0; f < F; ++f) {
      take_pin(age_byte(pins[f * n + i]), live[f * n + i] != 0, budget,
               in_msg, n_sus);
    }
    out[i] = merge_byte(age_byte(cur[i]), in_msg, n_sus, rx[i] != 0,
                        cap[i]);
  }
}

// Word form, as the kernels' body runs it: nw words, F pins each (pins
// and live are [F, nw]; live 0x03 and rx 0xFF per byte where set), one
// cap per word.
extern "C" void run_words(long nw, int F, const uint32_t* cur,
                          const uint32_t* pins, const uint32_t* live,
                          const uint32_t* rx, const int32_t* cap, int budget,
                          uint32_t* out) {
  const uint32_t budget_w = static_cast<uint32_t>(budget) * kLsb;
  for (long w = 0; w < nw; ++w) {
    PinWords acc;
    for (int f = 0; f < F; ++f) {
      take_pin_word(pins[f * nw + w], live[f * nw + w], budget_w, acc);
    }
    out[w] = merge_word(cur[w], acc, rx[w],
                        static_cast<uint32_t>(cap_clamp(cap[w])) * kLsb);
  }
}
"""


@pytest.fixture(scope="module")
def rule(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the rule for the host")
    d = tmp_path_factory.mktemp("belief_rule")
    (d / "rule.cpp").write_text(RULE_SRC)
    so = d / "librule.so"
    r = subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC",
                        f"-I{_build.CSRC}", "-o", str(so),
                        str(d / "rule.cpp")],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    lib = ctypes.CDLL(str(so))
    vp, cl, ci = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
    for fn in (lib.run_bytes, lib.run_words):
        fn.argtypes = [cl, ci] + [vp] * 5 + [ci, vp]
        fn.restype = None
    return lib


def _ptr(a: np.ndarray) -> int:
    assert a.flags.c_contiguous
    return a.ctypes.data


def _both_forms(lib, cur, pins, live, rx, cap, budget):
    """The byte form and the word form of the rule on ``cur`` [S, L] u8,
    ``pins`` [F, S, L] u8, ``live`` [F, L] bool, ``rx`` [L] bool, ``cap``
    [S] (L a multiple of 4)."""
    F, S, L = pins.shape
    n = S * L
    live_b = np.ascontiguousarray(np.broadcast_to(live[:, None, :], pins.shape)
                                  .astype(np.uint8))
    rx_b = np.ascontiguousarray(np.broadcast_to(rx, (S, L)).astype(np.uint8))
    cap_b = np.ascontiguousarray(np.repeat(cap.astype(np.int32), L))
    out_b = np.empty((S, L), np.uint8)
    lib.run_bytes(n, F, _ptr(cur), _ptr(pins), _ptr(live_b), _ptr(rx_b),
                  _ptr(cap_b), budget, _ptr(out_b))
    # The word form's masks: 0x03 per live sender, 0xFF per receiver; a
    # cap per word.  Held in names so that they outlive the call.
    live_w, rx_w = live_b * 3, rx_b * 0xFF
    cap_w = np.ascontiguousarray(cap_b[::4])
    out_w = np.empty((S, L), np.uint8)
    lib.run_words(n // 4, F, _ptr(cur), _ptr(pins), _ptr(live_w), _ptr(rx_w),
                  _ptr(cap_w), budget, _ptr(out_w))
    return out_b, out_w


def _merge_ref(cur, pins, live, rx, cap, budget):
    p = types.SimpleNamespace(spread_budget_rounds=budget)
    return fused.merge_ref(p, torch.from_numpy(cur), torch.from_numpy(pins),
                           torch.from_numpy(live), torch.from_numpy(rx),
                           torch.from_numpy(cap.astype(np.int32))).numpy()


# Caps 0..15, and caps above the nibble that the word form clamps.
CAPS = np.asarray(list(range(16)) + [16, 1000, 2**31 - 1], np.int64)


def test_word_form_exhaustive_one_pin(rule):
    """Every (current byte, pin byte, sender, receiver) on every cap row,
    at every budget 1..14."""
    c, pn, snd, r = np.meshgrid(np.arange(256), np.arange(256),
                                np.arange(2), np.arange(2), indexing="ij")
    L = c.size  # 262,144 columns, one combination each
    cur = np.ascontiguousarray(np.broadcast_to(c.reshape(-1), (len(CAPS), L))
                               .astype(np.uint8))
    pins = np.ascontiguousarray(cur.copy()[None])
    pins[0] = pn.reshape(-1).astype(np.uint8)
    live = snd.reshape(1, -1).astype(bool)
    rx = r.reshape(-1).astype(bool)
    for budget in range(1, 15):
        out_b, out_w = _both_forms(rule, cur, pins, live, rx, CAPS, budget)
        np.testing.assert_array_equal(out_w, out_b, err_msg=f"b={budget}")
        np.testing.assert_array_equal(
            out_b, _merge_ref(cur, pins, live, rx, CAPS, budget),
            err_msg=f"b={budget}")


@pytest.mark.parametrize("F", [3, 8])
def test_word_form_random_words(rule, F):
    """About 10**6 random words at fanout F, every budget; most bytes are
    SUSPECTs, so the count of suspicions reaches F."""
    rng = np.random.default_rng(F)
    S, L = len(CAPS), 16_000  # 76,000 words per budget

    def beliefs(shape):
        sus = rng.integers(0x40, 0x80, shape)  # msg 1, any conf and age
        return np.where(rng.random(shape) < 0.7, sus,
                        rng.integers(0, 256, shape)).astype(np.uint8)

    for budget in range(1, 15):
        cur = beliefs((S, L))
        pins = beliefs((F, S, L))
        live = rng.random((F, L)) < 0.7
        rx = rng.random(L) < 0.9
        out_b, out_w = _both_forms(rule, cur, pins, live, rx, CAPS, budget)
        np.testing.assert_array_equal(out_w, out_b, err_msg=f"b={budget}")
        np.testing.assert_array_equal(
            out_b, _merge_ref(cur, pins, live, rx, CAPS, budget),
            err_msg=f"b={budget}")
