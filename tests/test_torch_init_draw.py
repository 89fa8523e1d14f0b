"""The port's seeded initial state depends on the seed alone
(`models/draw.py`): the same bits at ATen's DEFAULT CPU path on one thread
and at the host's own vector path on four, the reference package's
distributions at full width, and one state a seed."""
import hashlib
import json
import math
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from nelegan_tpu_torch.config import Config
from nelegan_tpu_torch.train import gan

REPO = pathlib.Path(__file__).resolve().parents[1]
# the standard deviation of a unit normal truncated at +-2 (flax divides
# its truncated normal by it)
TRUNC_STD = 0.87962566103423978

# draws init_train_state(Config(), seed 0) on the CPU at argv[1] threads
# and prints its ATen CPU capability and each tensor's digest
_CHILD = """
import hashlib, json, sys, torch
from nelegan_tpu_torch.config import Config
from nelegan_tpu_torch.train.gan import init_train_state
torch.set_num_threads(int(sys.argv[1]))
s = init_train_state(Config(), 0, device="cpu")
print(json.dumps({
    "capability": torch.backends.cpu.get_cpu_capability(),
    "tensors": {f"{m}.{k}": hashlib.sha256(
        v.contiguous().view(torch.uint8).numpy().tobytes()).hexdigest()[:16]
        for m in ("gen", "d", "dq")
        for k, v in getattr(s, m).state_dict().items()}}))
"""


def _draw_in_child(threads: int, capability: str = None) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("ATEN_CPU_CAPABILITY", "OMP_NUM_THREADS")}
    if capability:
        env["ATEN_CPU_CAPABILITY"] = capability
    env["PYTHONPATH"] = os.pathsep.join(filter(None, (
        str(REPO), env.get("PYTHONPATH"))))
    out = subprocess.run([sys.executable, "-c", _CHILD, str(threads)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def state():
    return gan.init_train_state(Config(), 0, "cpu")


def test_draw_is_the_same_on_every_cpu_path():
    """(a) DEFAULT at one thread against the host's capability at four:
    every tensor bit-equal.  The digest of the whole state is printed: the
    card's smoke run prints its own beside it."""
    host = _draw_in_child(4)
    if host["capability"] == "DEFAULT":
        pytest.skip("the host's own ATen CPU capability is DEFAULT")
    default = _draw_in_child(1, "default")
    assert default["capability"] == "DEFAULT"
    assert len(host["tensors"]) == len(default["tensors"]) == 92
    differ = sorted(k for k, v in host["tensors"].items()
                    if default["tensors"][k] != v)
    assert not differ, (f"{len(differ)} of 92 tensors differ between "
                        f"DEFAULT and {host['capability']}: {differ[:6]}")
    digest = hashlib.sha256("".join(
        f"{k}:{v};" for k, v in sorted(host["tensors"].items())).encode())
    print(f"init_train_state(Config(), 0) digest {digest.hexdigest()[:16]} "
          f"(torch {torch.__version__})")


def test_distributions_at_full_width(state):
    """(b) xavier-uniform convs with the block's gain, lecun-normal dense
    layers truncated at 2 sigma (flax's rescale), he-uniform spectral-norm
    weights with a unit u and v = l2norm(W^T u), zero biases, unit cLN
    gains."""
    gen = state.gen
    for block, gain in zip(gen.convolutions, gen._gains):
        w = block[0].conv.weight.detach().double()
        out_ch, in_ch, k = w.shape
        bound = gain * math.sqrt(6.0 / ((in_ch + out_ch) * k))
        assert float(w.abs().max()) <= bound
        assert float(w.abs().max()) > 0.99 * bound
        assert abs(float(w.std()) / (bound / math.sqrt(3.0)) - 1.0) < 0.05
        assert not block[0].conv.bias.any()
        assert bool((block[2].gain0 == 1).all()) and not block[2].bias0.any()
    for fc in (gen.fc1, gen.fc2):
        w = fc.weight.detach().double()
        flax_std = math.sqrt(1.0 / fc.in_features)
        assert float(w.abs().max()) <= 2.0 * flax_std / TRUNC_STD
        assert abs(float(w.std()) / flax_std - 1.0) < 0.05
        assert not fc.bias.any()
    for d in (state.d, state.dq):
        for m in (*d.layers, d.fc1, d.fc2, d.fc3):
            w = m.weight_orig.detach().double()
            wmat = w.reshape(w.shape[0], -1)
            limit = math.sqrt(6.0 / wmat.shape[1])
            assert float(w.abs().max()) <= limit
            assert not m.bias.any()
            u = m.weight_u.double()
            assert abs(float(u.norm()) - 1.0) < 1e-6
            v = wmat.t() @ u
            torch.testing.assert_close(m.weight_v.double(), v / v.norm(),
                                       rtol=0, atol=1e-6)


def test_one_state_a_seed(state):
    """(c) The same seed twice in one process gives the same bits; another
    seed gives other weights."""
    again = gan.init_train_state(Config(), 0, "cpu")
    other = gan.init_train_state(Config(), 1, "cpu")
    for m in ("gen", "d", "dq"):
        for (k, x), y, z in zip(getattr(state, m).state_dict().items(),
                                getattr(again, m).state_dict().values(),
                                getattr(other, m).state_dict().values()):
            assert torch.equal(x.view(torch.uint8), y.view(torch.uint8)), k
            if k.endswith(("weight", "weight_orig", "weight_u",
                           "weight_v")):
                assert not torch.equal(x, z), k
