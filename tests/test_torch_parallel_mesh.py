"""The port's mesh, tensor plan and local-shard rules against the JAX
package, in this process: ``parallel/mesh.py:mesh_shape`` and each rank's
coordinates (a fake process group per rank) against
``ttt_video_dit_tpu.parallel.mesh.build_mesh`` on the conftest's 8 virtual
CPU devices; the tensor-axis placement of every parameter of the tiny model
(both variants) against the TENSOR entries of
``ttt_video_dit_tpu.parallel.sharding._spec_for`` at tp 2, 3 (every axis
dropped) and 8; ``local_head_count`` against the JAX one; and, on a gloo
world of one, the plan applied on size-1 axes (DTensor parameters, the same
forward bit for bit), the plan and FSDP2 there (every gradient bit-equal,
the time embedding's included: the DiT's fan-out sums it in layer order),
the fan-out itself, and every kernel wrapper refusing a DTensor.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor  # noqa: E402
from torch.testing._internal.distributed.fake_pg import FakeStore  # noqa: E402

import __graft_entry__  # noqa: E402
from ttt_video_dit_torch import convert  # noqa: E402
from ttt_video_dit_torch.models.dit.diffusion import CogVideoX as TorchCogVideoX  # noqa: E402
from ttt_video_dit_torch.models.dit import dit  # noqa: E402
from ttt_video_dit_torch.models.dit.dit import init_params_  # noqa: E402
from ttt_video_dit_torch.ops import attention, ttt_linear_kernel, ttt_mlp_kernel  # noqa: E402
from ttt_video_dit_torch.ops import convert as convert_ops  # noqa: E402
from ttt_video_dit_torch.parallel import mesh as t_mesh  # noqa: E402
from ttt_video_dit_torch.parallel import sharded as t_sharded  # noqa: E402
from ttt_video_dit_torch.parallel.sharding import apply_tensor_parallel, parallelize, tensor_dim  # noqa: E402
from ttt_video_dit_torch.training.optimizer import flax_path  # noqa: E402
from ttt_video_dit_tpu.models.dit.diffusion import CogVideoX  # noqa: E402
from ttt_video_dit_tpu.ops.pallas import sharded as j_sharded  # noqa: E402
from ttt_video_dit_tpu.parallel import mesh as j_mesh  # noqa: E402
from ttt_video_dit_tpu.parallel.sharding import _spec_for  # noqa: E402
from ttt_video_dit_tpu.training.optimizer import path_str  # noqa: E402

torch.set_num_threads(1)
CFG = __graft_entry__._flagship_config(tiny=True)

MESHES = [(1, -1, 1, 8), (2, -1, 2, 8), (1, -1, 8, 8), (2, 2, 2, 8), (1, 2, 1, 2), (2, 1, 2, 4), (1, 1, 2, 2),
          (1, -1, 3, 8), (2, 2, 1, 8), (1, 3, 1, 4), (4, -1, 4, 8)]


def _jax_mesh(rep, fsdp, tp, n):
    return j_mesh.build_mesh(rep, fsdp, tp, devices=jax.devices()[:n])


@pytest.mark.parametrize("rep,fsdp,tp,n", MESHES)
def test_mesh_shape_and_coordinates_match_jax(rep, fsdp, tp, n):
    """The same -1 inference and the same refusals (ValueError naming the
    flags here, AssertionError there); each rank r at the coordinates of
    device r in JAX's device array, its data rank r // tp."""
    try:
        want = _jax_mesh(rep, fsdp, tp, n)
    except AssertionError:
        with pytest.raises(ValueError, match="--parallelism"):
            t_mesh.mesh_shape(rep, fsdp, tp, n)
        return
    assert t_mesh.mesh_shape(rep, fsdp, tp, n) == tuple(want.devices.shape)
    devices = jax.devices()[:n]
    for rank in range(n):
        dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=n)
        try:
            mesh = t_mesh.build_mesh(rep, fsdp, tp, device_type="cpu")
            coord = tuple(mesh.get_coordinate())
            assert coord == tuple(int(i) for i in np.argwhere(want.devices == devices[rank])[0])
            assert (t_mesh.data_rank(mesh), t_mesh.data_size(mesh)) == (rank // want.shape["tensor"],
                                                                         n // want.shape["tensor"])
            assert t_mesh.tensor_rank(mesh) == coord[2]
        finally:
            dist.destroy_process_group()


def _flax_shapes(cfg):
    model = CogVideoX(cfg)
    vid = jnp.zeros((1, cfg.compressed_num_frames, cfg.in_channels, 2, 2), jnp.float32)
    text = jnp.zeros((1, 3, 9, cfg.text_dim), jnp.float32)
    bounds = (jnp.zeros((1,), jnp.int32), jnp.full((1,), cfg.sigma_interval, jnp.int32))
    return jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), vid, text, jax.random.PRNGKey(1), bounds))


@pytest.mark.parametrize("variant", ["ttt_mlp", "ttt_linear"])
@pytest.mark.parametrize("tp", [2, 3, 8])
def test_tensor_placement_matches_jax_rules(variant, tp):
    """Every parameter of the tiny model: the dim the port shards over
    ``tensor`` is the dim of the TENSOR entry of the JAX rule on the same flax
    path (a Dense kernel [in, out] is the port's weight [out, in]), or both
    replicate it; at tp 3 every axis drops."""
    cfg = dataclasses.replace(CFG, ssm_layer=variant)
    mesh = _jax_mesh(1, 1, tp, tp)
    leaves = jax.tree_util.tree_leaves_with_path(_flax_shapes(cfg))
    port = dict(TorchCogVideoX(cfg).named_parameters())
    assert len(port) == len(leaves)
    sharded = 0
    for p, leaf in leaves:
        tree = np.zeros(leaf.shape, np.float32)
        for key in reversed(path_str(p).split("/")):
            tree = {key: tree}
        (name,) = convert.flax_to_state_dict(tree)  # the port's name of this flax leaf
        spec = tuple(_spec_for(path_str(p), leaf.shape, mesh))
        jax_dim = spec.index("tensor") if "tensor" in spec else None
        if jax_dim is not None and path_str(p).endswith("kernel"):
            jax_dim = len(leaf.shape) - 1 - jax_dim
        assert tensor_dim(flax_path(name), tuple(port[name].shape), tp) == jax_dim, (name, spec)
        sharded += jax_dim is not None
    assert sharded == (0 if tp == 3 else 16 if variant == "ttt_mlp" else 14) * cfg.num_layers


@pytest.mark.parametrize("H", [1, 2, 3, 8, 48])
@pytest.mark.parametrize("tp", [1, 2, 3, 4, 8])
def test_local_head_count_matches_jax(H, tp):
    with j_mesh.use_mesh(_jax_mesh(1, 1, tp, tp)):
        want = j_sharded.local_head_count(H)
    assert t_sharded.local_head_count(H, tp) == want


@pytest.fixture
def world_of_one():
    """A gloo process group of one rank and its 1 x 1 x 1 mesh."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield t_mesh.build_mesh(1, 1, 1, device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_tensor_plan_on_size_one_axes_keeps_the_forward(world_of_one):
    """The plan at tp 1 (as the card runs it): the head-structured parameters
    become DTensors sharded on their rule's dim, the others stay tensors, the
    attention and TTT Linears get their styles, and the DiT's training loss
    and gradients equal the unsharded model's bit for bit."""
    cfg = dataclasses.replace(CFG, num_layers=1, use_kernel=True)
    torch.manual_seed(0)
    plain = init_params_(TorchCogVideoX(cfg), torch.Generator().manual_seed(3))
    model = init_params_(TorchCogVideoX(cfg), torch.Generator().manual_seed(3))
    apply_tensor_parallel(model, world_of_one)
    for name, p in model.named_parameters():
        dim = tensor_dim(flax_path(name), p.shape, 1)
        assert isinstance(p, DTensor) == (dim is not None), name
        if dim is not None:
            assert p.placements == (Shard(dim),), name
    ssm = model.dit.layers[0].seq_modeling_block.ssm
    assert (ssm.wq.style, ssm.wo.style, ssm.tp.size) == ("colwise", "rowwise", 1)
    rng = np.random.default_rng(0)
    vid = torch.from_numpy(rng.standard_normal((1, 37, 16, 2, 2)).astype(np.float32))
    text = torch.from_numpy(rng.standard_normal((1, 3, 9, cfg.text_dim)).astype(np.float32))
    bounds, idx = (torch.tensor([0]), torch.tensor([1000])), torch.tensor([400])
    noise = torch.from_numpy(rng.standard_normal(vid.shape).astype(np.float32))
    losses = []
    for m in (plain, model):
        loss = m(vid, text, bounds, idx=idx, noise=noise).mean()
        loss.backward()
        losses.append(loss)
    assert torch.equal(*losses)
    grads = dict(plain.named_parameters())
    for name, p in model.named_parameters():
        torch.testing.assert_close(t_sharded.full(p.grad), grads[name].grad, rtol=0, atol=0, msg=name)


def test_fsdp2_on_a_world_of_one_gives_the_unsharded_gradients(world_of_one):
    """The tensor plan and FSDP2 at world 1 (the training entry's torchrun
    branch, chip_smoke.py phase 13) against the unsharded model, in bf16 at 2
    layers: the loss and every gradient bit-equal, the time embedding's
    included. Its output feeds every layer's adaLN and FSDP2's per-layer
    backward hooks change the order in which those gradients arrive; the
    DiT's fan-out (models/dit/dit.py:FanOut) sums them in layer order."""
    cfg = dataclasses.replace(CFG, num_layers=2, use_kernel=True, dtype="bfloat16")
    plain = init_params_(TorchCogVideoX(cfg), torch.Generator().manual_seed(3))
    model = init_params_(TorchCogVideoX(cfg), torch.Generator().manual_seed(3))
    parallelize(model, world_of_one)
    rng = np.random.default_rng(1)
    vid = torch.from_numpy(rng.standard_normal((1, 37, 16, 2, 2)).astype(np.float32))
    text = torch.from_numpy(rng.standard_normal((1, 3, 9, cfg.text_dim)).astype(np.float32))
    bounds, idx = (torch.tensor([0]), torch.tensor([1000])), torch.tensor([400])
    noise = torch.from_numpy(rng.standard_normal(vid.shape).astype(np.float32))
    losses = []
    for m in (plain, model):
        loss = m(vid, text, bounds, idx=idx, noise=noise).float().mean()
        loss.backward()
        losses.append(loss)
    assert torch.equal(*losses)
    grads = dict(plain.named_parameters())
    for name, p in model.named_parameters():
        assert torch.equal(t_sharded.full(p.grad), grads[name].grad), name


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "float32"])
def test_fan_out_sums_its_gradients_in_copy_order(dtype):
    """dit.FanOut's backward against the plain sum of its cotangents in the
    copies' order (float32, one rounding to the dtype), bit for bit, whatever
    order autograd reaches the consumers in."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 16, generator=gen).to(dtype).requires_grad_()
    cots = [torch.randn(2, 16, generator=gen).to(dtype) * 4.0 ** (i % 5) for i in range(9)]
    want = cots[0].float()
    for c in cots[1:]:
        want = want + c.float()
    copies = dit.FanOut.apply(x, len(cots))
    assert len(copies) == len(cots) and all(torch.equal(c, x) for c in copies)
    torch.autograd.backward([copies[i] * 1 for i in (4, 0, 8, 2, 6, 1, 7, 3, 5)],
                            [cots[i] for i in (4, 0, 8, 2, 6, 1, 7, 3, 5)])
    assert x.grad.dtype == dtype and torch.equal(x.grad, want.to(dtype))


def _dtensor_calls():
    q = torch.zeros(1, 16, 2, 64, dtype=torch.bfloat16)
    lse, x = torch.zeros(1, 2, 16), torch.zeros(1, 2, 8, 128, dtype=torch.bfloat16)
    gate, tab, ln = torch.zeros(1, 2, 2, 8), torch.zeros(2, 8, 64), torch.zeros(2, 64)
    mlp = (torch.zeros(2, 64, 256), torch.zeros(2, 1, 256), torch.zeros(2, 256, 64), torch.zeros(2, 1, 64))
    lin = (torch.zeros(2, 64, 64), torch.zeros(2, 1, 64))
    scan = (x, x, x, gate, tab, tab, ln, ln)
    return {
        "attention": (attention.attention, (q, q, q), 0),
        "attention_train": (attention.attention_train, (q, q, q), 1),
        "attention_backward": (attention.attention_backward, (q, q, q, q, lse, q), 3),
        "ttt_mlp_forward": (ttt_mlp_kernel.ttt_mlp_forward, (*scan, *mlp, 0.1), 8),
        "ttt_mlp_train": (ttt_mlp_kernel.ttt_mlp_train, (*scan, *mlp, 0.1, 4), 6),
        "ttt_mlp_backward": (ttt_mlp_kernel.ttt_mlp_backward, (*scan, *mlp, x, 0.1, 4), 12),
        "ttt_linear_forward": (ttt_linear_kernel.ttt_linear_forward, (*scan, *lin, 0.1), 8),
        "ttt_linear_train": (ttt_linear_kernel.ttt_linear_train, (*scan, *lin, 0.1, 4), 7),
        "ttt_linear_backward": (ttt_linear_kernel.ttt_linear_backward, (*scan, *lin, x, 0.1, 4), 10),
        "convert_f32_bf16": (convert_ops.convert_f32_bf16, (torch.zeros(4, 4),), 0),
        "opaque_convert": (convert_ops.opaque_convert, (torch.zeros(4, 4), torch.bfloat16), 0),
    }


@pytest.mark.parametrize("wrapper", list(_dtensor_calls()))
def test_kernel_wrapper_refuses_a_dtensor(world_of_one, wrapper):
    """A DTensor handed to any kernel wrapper (or its training Function's
    entry) raises TypeError, on the CPU too, where the wrapper would
    otherwise take the plain version: none falls back."""
    fn, args, at = _dtensor_calls()[wrapper]
    args = list(args)
    args[at] = distribute_tensor(args[at], world_of_one["tensor"], [Replicate()])
    with pytest.raises(TypeError, match="DTensor"):
        fn(*args)
