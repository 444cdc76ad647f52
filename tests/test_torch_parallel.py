"""The port's mesh and sharding rules against the JAX package's, the
rank launcher and the tensor-parallel collectives, on the CPU."""

import jax
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from test_torch_common import CPU

from speechcatcher_tpu_torch.config import tiny_config
from speechcatcher_tpu_torch.ops.layers import quantize_params_int8
from speechcatcher_tpu_torch.parallel.launch import run_ranks
from speechcatcher_tpu_torch.parallel.mesh import (
    hybrid_device_grid,
    initialize_distributed,
    make_hybrid_mesh,
    make_mesh,
    param_specs,
)
from speechcatcher_tpu_torch.params import (
    params_from_numpy,
    random_params,
    unstack_layers,
)


def _flat(tree, path=""):
    """{path: spec tuple}; dicts and lists are containers, every other
    node (a tuple or a PartitionSpec) a spec."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{path}/{i}"))
        return out
    return {path: tuple(tree)}


@pytest.mark.parametrize("encoder_type", ["transformer", "conformer"])
@pytest.mark.parametrize("precision", ["float32", "int8_all"])
def test_param_specs_match_jax(encoder_type, precision):
    """Leaf for leaf on the layer-stacked tree, as tuples; the port's
    per-layer lists get the same specs without the layer axis."""
    import jax.numpy as jnp

    from speechcatcher_tpu.ops.layers import (
        quantize_params_int8 as jax_quantize,
    )
    from speechcatcher_tpu.parallel.mesh import param_specs as jax_specs

    cfg = tiny_config(encoder_type=encoder_type)
    tree = params_from_numpy(random_params(cfg, seed=1), CPU)
    jtree = jax.tree.map(lambda x: jnp.asarray(x.numpy()), tree)
    if precision == "int8_all":
        tree = quantize_params_int8(tree, scope=None)
        jtree = jax_quantize(jtree, scope=None)
    got = _flat(param_specs(tree))
    want = _flat(jax_specs(jtree))
    assert got == want
    assert ("tp", None) in set(got.values())
    assert (None, None, "tp") in set(got.values())
    if precision == "int8_all":
        assert got["/encoder/layers/self_attn/linear_q/weight_scale"] == (
            None, "tp")
        assert got["/encoder/layers/self_attn/linear_out/weight_scale"] == (
            None,)

    for part in ("encoder", "decoder"):
        tree[part]["layers"] = unstack_layers(tree[part]["layers"])
    per_layer = _flat(param_specs(tree))
    for path, spec in per_layer.items():
        if "/layers/" in path:
            head, tail = path.split("/layers/")
            stacked = f"{head}/layers/{tail.split('/', 1)[1]}"
            assert (None, *spec) == want[stacked], path
        else:
            assert spec == want[path], path


class _FakeDev:
    def __init__(self, pid, local_id):
        self.process_index = pid
        self.id = pid * 100 + local_id


def _ids(grid):
    return [[d.id for d in row] for row in grid]


@pytest.mark.parametrize("hosts,local,tp", [(4, 8, 4), (2, 4, 2), (1, 8, 1)])
def test_hybrid_device_grid_matches_jax(hosts, local, tp):
    from speechcatcher_tpu.parallel.mesh import (
        hybrid_device_grid as jax_grid,
    )

    devs = [_FakeDev(p, i) for p in range(hosts) for i in range(local)]
    got = hybrid_device_grid(devs, tp=tp)
    assert got.shape == (hosts * local // tp, tp)
    assert _ids(got) == _ids(jax_grid(devs, tp=tp))
    for row in got:
        assert len({d.process_index for d in row}) == 1


@pytest.mark.parametrize("devs,tp,match", [
    ([_FakeDev(p, i) for p in range(4) for i in range(2)], 4, "span hosts"),
    ([_FakeDev(0, i) for i in range(4)] + [_FakeDev(1, 0)], 1, "unequal"),
])
def test_hybrid_device_grid_raises_as_jax(devs, tp, match):
    from speechcatcher_tpu.parallel.mesh import (
        hybrid_device_grid as jax_grid,
    )

    with pytest.raises(ValueError, match=match):
        jax_grid(devs, tp=tp)
    with pytest.raises(ValueError, match=match):
        hybrid_device_grid(devs, tp=tp)


def test_initialize_distributed_validates_args():
    assert initialize_distributed(None, None, None) is False
    with pytest.raises(ValueError, match="requires"):
        initialize_distributed("host0:1234", None, None)
    with pytest.raises(ValueError, match="requires"):
        initialize_distributed("host0:1234", 2, None, backend="gloo")
    with pytest.raises(ValueError, match="only with --coordinator"):
        initialize_distributed(None, 2, None)
    with pytest.raises(ValueError, match="only with --coordinator"):
        initialize_distributed(None, None, 1)
    with pytest.raises(ValueError, match=r"not in \[0, 2\)"):
        initialize_distributed("host0:1234", 2, 2, backend="gloo")


def test_make_mesh_over_cpu_devices():
    mesh = make_mesh(4, devices=[CPU] * 4)
    assert mesh.shape == {"dp": 4, "tp": 1}
    assert mesh.axis_names == ("dp", "tp")
    assert mesh.local_rows() == [(i, CPU) for i in range(4)]
    assert mesh.coord is None and mesh.tp_group is None
    assert make_hybrid_mesh(tp=1, local_devices=[CPU] * 2).shape == {
        "dp": 2, "tp": 1}


def test_make_mesh_raises_without_the_devices():
    with pytest.raises(ValueError, match="requested 2 devices, only 1 "
                       r"available \(cpu\)\. Pass devices= explicitly"):
        make_mesh(2, devices=[CPU])
    if torch.cuda.device_count() < 16:
        with pytest.raises(ValueError, match="requested 16 devices"):
            make_mesh(16)
    with pytest.raises(ValueError, match="process group of 2 ranks"):
        make_mesh(2, tp=2, devices=[CPU] * 2)
    with pytest.raises(ValueError, match="does not divide"):
        make_mesh(3, tp=2, devices=[CPU] * 3)


def test_tp_collectives_forward_and_backward(tmp_path):
    out = run_ranks(ranks.tp_collectives, 2, str(tmp_path / "rdv"),
                    timeout=120)
    for r, (copy, reduce, gather, rows) in enumerate(out):
        # copy: identity forward, gradient summed over the ranks (1 + 2).
        np.testing.assert_array_equal(copy[0], np.full((2, 3), r + 1.0))
        np.testing.assert_array_equal(copy[1], np.full((2, 3), 3.0))
        # reduce: sum forward (1 + 2), gradient passed through.
        np.testing.assert_array_equal(reduce[0], np.full((2, 3), 3.0))
        np.testing.assert_array_equal(reduce[1], np.full((2, 3), r + 1.0))
        # gather: blocks side by side, gradient the rank's own block.
        np.testing.assert_array_equal(
            gather[0], np.repeat([[1.0, 2.0]], 3, axis=1).repeat(2, axis=0))
        np.testing.assert_array_equal(
            gather[1], np.tile(np.arange(3.0) + 3 * r, (2, 1)))
        # the vocab-sharded lookup: rows 0, 3, 2, 1 of arange(8) (4, 2).
        np.testing.assert_array_equal(
            rows, np.arange(8.0).reshape(4, 2)[[0, 3, 2, 1]])


def test_make_hybrid_mesh_on_two_ranks(tmp_path):
    out = run_ranks(ranks.hybrid_meshes, 2, str(tmp_path / "rdv"),
                    timeout=120)
    for r, (hosts, rows, coord, cards, card_coord, per_card) in \
            enumerate(out):
        assert hosts == {"dp": 4, "tp": 1} and coord is None
        assert rows == [2 * r, 2 * r + 1]
        assert cards == {"dp": 1, "tp": 2}
        assert card_coord == (0, r) and per_card


def test_run_ranks_raises_with_the_rank_traceback(tmp_path):
    with pytest.raises(RuntimeError, match="(?s)rank 1 of 2 failed.*"
                       "ValueError: rank 1 says no"):
        run_ranks(ranks.fails_on_rank, 2, str(tmp_path / "rdv"),
                  timeout=120, args=(1,))


def test_run_ranks_enforces_its_time_limit(tmp_path):
    with pytest.raises(TimeoutError, match="did not return within"):
        run_ranks(ranks.sleeps, 2, str(tmp_path / "rdv"), timeout=5,
                  args=(60,))
    assert run_ranks(ranks.sleeps, 2, str(tmp_path / "rdv2"), timeout=60,
                     args=(0,)) == [0, 1]
