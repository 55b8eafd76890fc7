"""Textgen's parity at its served dtype, bfloat16: the port against the
reference (``tpuserve/models/textgen.py``) on the CPU, dense MLP and
Switch-MoE (E 4), dense and flash prefill, on the same weights (the
reference's seeded tree, cast to bf16 in both packages), at 2 layers and
d 64 (``tests/test_torch_textgen.py``'s harness, widened to where bf16
rounding shows).

The two frameworks round the bf16 activations at different points, so the
logits differ and a token can flip where two candidates nearly tie; the
divergence compounds if each package feeds back its own tokens. The test
therefore TEACHER-FORCES: before every decode step the port's lanes take
the reference's tokens, so each step compares the two packages on the same
history. Stated bound and rule:

- every prefill and per-step logit within ``BF16_LOGIT_TOL`` = 0.0625 abs
  of the reference's. The logits lie in [-8, 8) at these widths, where a
  bf16 spacing is 2**-5 = 0.03125; the bound is two spacings (measured
  on this CPU harness: at most 0.0343 over the eight cases' 8 lanes x 13
  sampling steps);
- tokens identical, except where the reference's top-two margin in logit
  units (the margin of its sampling scores logits / t + Gumbel, times t;
  the logit margin when greedy) is below ``BF16_LOGIT_TOL``. Such steps
  are printed (measured: 6 of 832 sampled tokens, all at margins below
  0.01).

The same rule holds the card's bf16 flash prefill against dense in
``chip_smoke.py`` phase 19 (at a lane's first divergence).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_textgen import decision_margins, record_sampling, seeded_items, torch_batch
from tpuserve import config as jconfig
from tpuserve.models import build as jax_build
from tpuserve_torch import config as tconfig
from tpuserve_torch.models import build as port_build

BF16_LOGIT_TOL = 0.0625
OPTS = dict(layers=2, d_model=64, heads=2, d_ff=128, vocab_size=512,
            prompt_len=16, max_new_tokens=24)
STEPS = 12
LANES = ("pos", "tokens", "n_new", "last", "done")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def cfg(pkg, **opts):
    return pkg.ModelConfig(name="tg", family="textgen", batch_buckets=[1, 8],
                           dtype="bfloat16", parallelism="single",
                           options={**OPTS, **opts})


def logit_margins(call) -> np.ndarray:
    """The reference's top-two margin per lane in logit units."""
    _logits, _seed, _pos, temp = call
    return decision_margins(call) * np.where(temp > 0, temp, 1.0)


@pytest.mark.parametrize("moe", [0, 4], ids=["dense_mlp", "moe"])
@pytest.mark.parametrize("attention", ["dense", "flash"])
@pytest.mark.parametrize("temp", [0.0, 0.7])
def test_bf16_teacher_forced_logits_and_tokens(attention, moe, temp):
    jm = jax_build(cfg(jconfig, attention=attention, moe_experts=moe))
    tm = port_build(cfg(tconfig, attention=attention, moe_experts=moe))
    params = jax.device_get(jm.init_params(jax.random.key(3)))
    bf16 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16), params)
    module = tm.build_module()
    module.load_state_dict(tm.from_jax_params(params))
    module.to(torch.bfloat16).eval()
    batch = jm.assemble(seeded_items(jm, 8, seed=11 if temp else 12, temp=temp), (8,))
    jcalls, tcalls = [], []
    jo = record_sampling(jm, jcalls, np.asarray)
    to = record_sampling(tm, tcalls, lambda a: a.detach().float().numpy().copy())
    ref_tok, got_tok = [], []
    try:
        js = jm._prefill(bf16, *batch)
        with torch.no_grad():
            ts = tm._prefill(module, *torch_batch(batch))
            ref_tok.append(np.asarray(js["last"]))
            got_tok.append(ts["last"].numpy().copy())
            for _ in range(STEPS):
                for k in LANES:  # teacher forcing: the reference's history
                    ts[k].copy_(torch.from_numpy(np.array(js[k])))
                js, _ = jm._decode_step(bf16, js)
                tm._decode_step(module, ts)
                ref_tok.append(np.asarray(js["last"]))
                got_tok.append(ts["last"].numpy().copy())
    finally:
        jm._sample, tm._sample = jo, to
    assert len(jcalls) == len(tcalls) == STEPS + 1
    worst = 0.0
    for i, (jc, tc) in enumerate(zip(jcalls, tcalls)):
        diff = float(np.abs(tc[0] - jc[0].astype(np.float32)).max())
        worst = max(worst, diff)
        assert diff <= BF16_LOGIT_TOL, f"step {i}: logits differ by {diff:.4f}"
    near_ties = []
    for step, (ref, got) in enumerate(zip(ref_tok, got_tok)):
        margins = logit_margins(jcalls[step])
        for lane in np.nonzero(ref != got)[0]:
            assert margins[lane] < BF16_LOGIT_TOL, (
                f"step {step} lane {lane}: token {got[lane]} != reference {ref[lane]} "
                f"at a reference margin of {margins[lane]:.4f}")
            near_ties.append((step, int(lane), float(margins[lane])))
    print(f"max logit diff {worst:.4f}; differing tokens (step, lane, margin): {near_ties}")
