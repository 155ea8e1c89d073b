import subprocess
import sys

from portbench import nojax
from portbench.spec import ROOT


def test_top_level_names_are_compared_whole():
    mods = ["alayalite_tpu_torch", "alayalite_tpu_torch.index.search",
            "jaxtyping", "flaxen", "numpy"]
    assert nojax.found(mods) == []
    assert nojax.found(mods + ["jax._src.core", "flax.linen"]) == ["flax",
                                                                   "jax"]
    assert nojax.found(["alayalite_tpu.ops.topk"]) == ["alayalite_tpu"]
    assert nojax.found(["jaxlib.xla_client"]) == ["jaxlib"]


def test_the_harness_and_the_port_load_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.run, portbench.loops, portbench.reference\n"
            "import alayalite_tpu_torch, alayalite_tpu_torch.serving\n"
            "from alayalite_tpu_torch.index import captured\n"
            "from portbench import nojax, spec\n"
            "for w in spec.benchmark()['workloads']:\n"
            "    c = spec.cell(w['name'])\n"
            "    spec.traffic_kind(c.traffic['kind'])\n"
            "    [spec.reader(m['name']) for m in c.end_to_end + c.per_layer]\n"
            "print(nojax.found())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
