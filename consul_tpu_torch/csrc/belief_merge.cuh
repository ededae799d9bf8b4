// The rule of the SWIM dissemination tail, for the port's Hopper kernel
// (dissem_tail.cu: fused_dissem, the single-device pass, and fused_merge,
// all shards of the sharded round), and for the CPU test that holds the
// word form against the byte form.
//
// A belief byte is msg:2 | conf:2 | age:4 (consul_tpu_torch/gossip/
// kernel.py).  The rule is the reference's consul_tpu/gossip/fused.py
// `_age_u8` and `_merge`, in two forms.
//
// Per byte, on an int (the spec, and the kernels' ragged edges):
//   age_byte   ages one byte;
//   take_pin   folds one aged incoming pin into the running priority-max
//              message and SUSPECT count;
//   merge_byte applies the upgrade or the capped Lifeguard confirmation
//              bump to the aged current byte and packs the result.
//
// Per 32-bit word, four belief bytes of one row side by side (the
// reference's SWAR form, consul_tpu/gossip/kernel.py::_disseminate_swar
// with prefuse): take_pin_word and merge_word.
//   - Every per-byte field stays below 0x80 while it is compared, so the
//     borrow-guard compare ((a | 0x80) - b, bit 7 per byte) is exact, and
//     no sum carries out of its byte; one PRMT spreads bit 7 over its
//     byte (sign_bytes).
//   - The age tick is never applied to a pin: the budget test on the raw
//     age is the shifted threshold ((age + 1) & 15) < budget, exact for a
//     budget in [1, 14] (SwimParams.spread_budget_rounds clamps it there;
//     the wrappers refuse any other).
//   - Priority-max over the pins is an OR: a pin's message sets "some
//     message at least 2" (msg bit 1), "some message 1 or 3" (msg bit 0)
//     and, separately, "some message 3"; the maximum is decoded from the
//     three once per word.
//   - The SUSPECT count is the plain sum of the live messages: it is read
//     only where the maximum is a SUSPECT, and then every live message is
//     0 or 1.
//   - The merge takes a cap clamped into [0, 15] (cap_clamp): for any
//     cap >= 0 that is exact, since conf + n_sus <= 3 + 8.
// Written in plain integer C++, which nvcc maps to LOP3/IADD3/SHF, and one
// PRMT per compare; the SIMD video intrinsics (__vcmpgeu4 and the like)
// are emulated with several instructions each on sm_90.  Off the card
// (the CPU tests compile this header with g++) sign_bytes is its portable
// equivalent.

#pragma once

#include <cstdint>

// One round of aging on a belief byte held in an int: the fresh sentinel
// 0xF becomes age 0, real ages saturate at 14, message-free bytes stay as
// they are.
__device__ __forceinline__ int age_byte(int x) {
  if ((x >> 6) == 0) return x;
  const int age = x & 0xF;
  const int aged = age == 0xF ? 0 : min(age + 1, 14);
  return (x & 0xF0) | aged;
}

// An aged pin counts when its age is below the spread budget and its
// sender is alive: its message joins the priority-max, and a SUSPECT adds
// one to the count of independent suspicions heard this round.
__device__ __forceinline__ void take_pin(int pin, bool sender_live,
                                         int budget, int& in_msg,
                                         int& n_sus) {
  const int m = ((pin & 0xF) < budget && sender_live) ? pin >> 6 : 0;
  in_msg = max(in_msg, m);
  n_sus += m == 1;
}

// The merged byte.  `cur` is already aged; `rx` says whether the receiver
// takes messages; `cap` is its slot's confirmation cap.  A higher message
// upgrades the byte (conf 0, age 0); a SUSPECT heard by a suspecting
// receiver raises conf up to `cap`, and a rising count resets the age.
__device__ __forceinline__ uint8_t merge_byte(int cur, int in_msg, int n_sus,
                                              bool rx, int cap) {
  const int cur_msg = cur >> 6;
  const int conf = (cur >> 4) & 0x3;
  const bool upgraded = in_msg > cur_msg && rx;
  const bool bump = cur_msg == 1 && in_msg == 1 && rx;
  const int conf_new = bump ? min(conf + n_sus, cap) : conf;
  const bool conf_rose = conf_new > conf;
  const int out_msg = upgraded ? in_msg : cur_msg;
  const int out_age = (upgraded || conf_rose) ? 0 : (cur & 0xF);
  const int out_conf = upgraded ? 0 : conf_new;
  return static_cast<uint8_t>((out_msg << 6) | (out_conf << 4) | out_age);
}

// The confirmation cap both forms take: merge_byte gives the same byte
// for `cap` and cap_clamp(cap) whenever cap >= 0 (the round's caps are
// clamped at 0, gossip/kernel.py), and the word form needs it in a nibble.
__device__ __forceinline__ int cap_clamp(int cap) {
  return cap < 0 ? 0 : (cap > 15 ? 15 : cap);
}

// ---- Four bytes to a 32-bit word -----------------------------------------

constexpr uint32_t kLsb = 0x01010101u;   // bit 0 of each byte
constexpr uint32_t kB7 = 0x80808080u;    // bit 7 of each byte
constexpr uint32_t kLow2 = 0x03030303u;  // a 2-bit field at each byte's foot
constexpr uint32_t kLow4 = 0x0F0F0F0Fu;  // the age nibble of each byte
constexpr uint32_t kMsgBits = 0xC0C0C0C0u;  // the message field in place

// Per byte: 0xFF where the byte's bit 7 is set, else 0x00.  On the card
// one PRMT in its sign-replicating mode (selector nibbles 8 + byte).
__device__ __forceinline__ uint32_t sign_bytes(uint32_t x) {
#ifdef __CUDA_ARCH__
  uint32_t r;
  asm("prmt.b32 %0, %1, 0, 0xBA98;" : "=r"(r) : "r"(x));
  return r;
#else
  return ((x >> 7) & kLsb) * 0xFFu;
#endif
}

// Per byte: 0xFF where a >= b, else 0x00 (both fields below 0x80).
__device__ __forceinline__ uint32_t ge_mask(uint32_t a, uint32_t b) {
  return sign_bytes((a | kB7) - b);
}

// Per byte: 0xFF where the field x (below 0x80) is not 0, else 0x00.
__device__ __forceinline__ uint32_t nonzero_mask(uint32_t x) {
  return sign_bytes(x + 0x7F7F7F7Fu);
}

// Per byte: a where the mask byte is 0xFF, b where it is 0x00.
__device__ __forceinline__ uint32_t sel(uint32_t mask, uint32_t a,
                                        uint32_t b) {
  return (a & mask) | (b & ~mask);
}

// The pins of one word, folded: bits 0-1 of each byte of `any` are the OR
// of the live messages (bit 1: some message >= 2; bit 0: some message 1
// or 3), bit 0 of `top` is "some message 3", and each byte of `msg_sum`
// is the sum of the live messages (at most 3 * 8), which is the count of
// SUSPECTs wherever merge_word uses it.
struct PinWords {
  uint32_t any = 0;
  uint32_t top = 0;
  uint32_t msg_sum = 0;
};

// take_pin on four raw (not yet aged) pin bytes.  `live`: 0x03 per byte
// whose sender is alive, else 0x00; `budget_w`: budget * kLsb, budget in
// [1, 14].
__device__ __forceinline__ void take_pin_word(uint32_t pin, uint32_t live,
                                              uint32_t budget_w,
                                              PinWords& acc) {
  // (age + 1) & 15 is the aged age, but 15 for age 14 (aged 14): both are
  // >= every budget <= 14.  t per byte is 0x72-0x7F (bits 4-6 set) where
  // it is below the budget and 0x80-0x8E (bits 4-6 clear) where not.
  // (y & kLow4) | kB7 is (y & kLow4) + kB7: the constant kB7 - budget_w
  // folds into one add, hoisted out of the caller's loop.
  const uint32_t y = (pin & kLow4) + kLsb;
  const uint32_t t = (y & kLow4) + (kB7 - budget_w);
  const uint32_t m = (pin >> 6) & (t >> 5) & live;
  acc.any |= m;
  acc.top |= m & (m >> 1);
  acc.msg_sum += m;
}

// The priority-max message of the folded pins, per byte in bits 0-1.
__device__ __forceinline__ uint32_t in_msg_word(const PinWords& acc) {
  const uint32_t lo = acc.top | (acc.any & ~(acc.any >> 1));
  return (acc.any & (kLow2 - kLsb)) | (lo & kLsb);
}

// merge_byte on four raw (not yet aged) current bytes: age them, merge
// the folded pins.  `rx`: 0xFF per byte whose receiver takes messages;
// `cap_w`: cap_clamp(cap) * kLsb.
__device__ __forceinline__ uint32_t merge_word(uint32_t cur,
                                               const PinWords& acc,
                                               uint32_t rx, uint32_t cap_w) {
  const uint32_t in = in_msg_word(acc);
  const uint32_t cm = (cur >> 6) & kLow2;
  const uint32_t conf = (cur >> 4) & kLow2;
  // The aged age: y = age + 1; the fresh 0xF wraps to 0 under the mask,
  // and y == 15 (age 14) steps back to 14.  Message-free bytes keep it.
  const uint32_t age = cur & kLow4;
  const uint32_t y = age + kLsb;
  const uint32_t at15 = (y + kLsb) & ~y & (kLsb << 4);
  const uint32_t aged = (y - (at15 >> 4)) & kLow4;
  const uint32_t age_c = sel(nonzero_mask(cm), aged, age);

  const uint32_t upgraded = ~ge_mask(cm, in) & rx;
  // Both SUSPECT (1).  Then no live pin carried more than a SUSPECT, so
  // the sum of the live messages is the count of SUSPECTs.
  const uint32_t bump = ~nonzero_mask((cm ^ kLsb) | (in ^ kLsb)) & rx;
  const uint32_t sum = conf + acc.msg_sum;  // <= 3 + 24 per byte
  const uint32_t capped = sel(ge_mask(cap_w, sum), sum, cap_w);
  const uint32_t conf_new = sel(bump, capped, conf);
  const uint32_t rose = ~ge_mask(conf, conf_new);
  const uint32_t keep = (cur & kMsgBits) | (conf_new << 4) | (age_c & ~rose);
  return sel(upgraded, in << 6, keep);
}
