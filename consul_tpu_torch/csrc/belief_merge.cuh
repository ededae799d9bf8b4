// The per-byte rule of the SWIM dissemination tail, shared by the port's
// two Hopper kernels (fused_dissem.cu, the single-device pass; and
// fused_merge.cu, one shard of the sharded round), so that the merge has
// one source on the card.
//
// A belief byte is msg:2 | conf:2 | age:4 (consul_tpu_torch/gossip/
// kernel.py).  The rule is the reference's consul_tpu/gossip/fused.py
// `_age_u8` and `_merge`, per byte, on an int:
//   age_byte   ages one byte;
//   take_pin   folds one aged incoming pin into the running priority-max
//              message and SUSPECT count;
//   merge_byte applies the upgrade or the capped Lifeguard confirmation
//              bump to the aged current byte and packs the result.

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
