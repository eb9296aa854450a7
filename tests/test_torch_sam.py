"""The port's SAM (``models/sam.py``) and its weight bridge against the JAX package's.

Two sources of the same weights, at ``IMG`` 96 as ``tests/test_sam_parity.py``
(a 6×6 token grid: the windowed blocks pad it to 14, the global blocks see 6×6):

  * ``tests/torch_ref/sam_torch.py``'s randomised state dict, with the released
    segment-anything key layout: the port loads it strictly
    (``load_sam_state_dict``), the JAX package through its own
    ``convert_sam_state_dict``;
  * seeded JAX variables (``tests/torch_parity.py seeded_sam_variables``: LeCun
    kernels, non-zero rel-pos tables and tokens), carried to the port by
    ``export_sam_state_dict``.

Limits, fp32 with TF32 off: the encoder 2e-4 (``test_sam_parity.py``'s);
prompt encoding 1e-5; ``decode_points`` IoU 1e-3 / 5e-4 and masks 1e-3 / 2e-3
(rtol / atol, the JAX package's own); the pos-embed and rel-pos interpolation
1e-6 of the JAX package's helpers; the export round trip bit for bit.  The
bf16 model by ``tests/test_torch_bf16.py``'s rule against JAX's bf16 model.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import sam_template, seeded_sam_variables
from tests.torch_parity import torch_single_thread  # noqa: F401  (autouse fixture)
from tests.torch_ref.sam_torch import Sam as RefSam
from tests.torch_ref.sam_torch import randomize
from yolo_puncture_tpu.models import sam as jsam
from yolo_puncture_tpu.utils import torch_convert as jconv
from yolo_puncture_tpu_torch.models import sam as psam
from yolo_puncture_tpu_torch.utils.convert import (
    export_sam_state_dict,
    load_sam_state_dict,
    resize_sam_pos_embed,
    resize_sam_rel_pos,
    sam_flax_path_to_torch_key,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

IMG = 96
ENC_TOL = 2e-4
PE_TOL = 1e-5
IOU_RTOL, IOU_ATOL = 1e-3, 5e-4
MASK_RTOL, MASK_ATOL = 1e-3, 2e-3
BF16_RULE = 1.5


@functools.lru_cache(maxsize=None)
def _template():
    return sam_template(IMG)


def _seeded_variables(seed=0):
    return seeded_sam_variables(IMG, seed)


@functools.lru_cache(maxsize=None)
def _sources():
    """{name: (JAX variables, port model)} for the two weight sources, and the reference torch model."""
    ref = randomize(RefSam(variant="vit_b", img_size=IMG), seed=0)
    sd = {k: v.detach().numpy() for k, v in ref.state_dict().items()}
    jvars, report = jconv.convert_sam_state_dict(sd, _template(), strict=True)
    from_ref = psam.SAM("vit_b", img_size=IMG)
    load_sam_state_dict(from_ref, sd)
    seeded = _seeded_variables()
    from_jax = psam.SAM("vit_b", img_size=IMG)
    load_sam_state_dict(from_jax, export_sam_state_dict(seeded))
    return {"sam_torch": (jax.device_get(jvars), from_ref), "jax": (seeded, from_jax)}, ref


@functools.lru_cache(maxsize=None)
def _jax_encode():
    return jax.jit(functools.partial(jsam.SAM(variant="vit_b", img_size=IMG).apply, method=jsam.SAM.encode_image))


def _image(seed=1):
    return np.random.default_rng(seed).normal(0, 1, size=(1, IMG, IMG, 3)).astype(np.float32)


def _prompts(seed=2, B=3, P=3):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0.05, 0.95, size=(B, P, 2)).astype(np.float32)
    lbl = rng.integers(-1, 2, size=(B, P)).astype(np.int32)
    lbl[:, 0] = 1
    return pts, lbl


@pytest.mark.parametrize("source", ["sam_torch", "jax"])
def test_image_encoder_matches_jax(source):
    sources, _ = _sources()
    jvars, model = sources[source]
    img = _image()
    ref = np.asarray(_jax_encode()(jvars, jnp.asarray(img)))
    got = model.encode_image(torch.from_numpy(img).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == (1, IMG // 16, IMG // 16, 256) and ref.std() > 0.01
    np.testing.assert_allclose(got, ref, rtol=ENC_TOL, atol=ENC_TOL)


def test_image_encoder_matches_sam_torch():
    """The released key layout loads by key and computes segment-anything's encoder."""
    sources, ref = _sources()
    x = torch.from_numpy(_image(4)).permute(0, 3, 1, 2)
    with torch.no_grad():
        want = ref.image_encoder(x).numpy()
    got = sources["sam_torch"][1].encode_image(x).numpy()
    np.testing.assert_allclose(got, want, rtol=ENC_TOL, atol=ENC_TOL)


@pytest.mark.parametrize("source", ["sam_torch", "jax"])
def test_prompt_encoding_matches_jax(source):
    """Point embeddings (labels 1, 0 and −1) and the dense positional encoding."""
    sources, _ = _sources()
    jvars, model = sources[source]
    pts, lbl = _prompts()
    jm = jsam.SAM(variant="vit_b", img_size=IMG)
    ref = np.asarray(jm.apply(jvars, jnp.asarray(pts), jnp.asarray(lbl),
                              method=lambda m, p, l: m.prompt_encoder.embed_points(p, l)))
    got = model.prompt_encoder.embed_points(torch.from_numpy(pts), torch.from_numpy(lbl).long()).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=PE_TOL)
    ref_pe = np.asarray(jm.apply(jvars, method=lambda m: m.prompt_encoder.dense_pe(6, 6)))
    got_pe = model.prompt_encoder.dense_pe(6, 6).detach().numpy()
    np.testing.assert_allclose(got_pe, ref_pe, rtol=0, atol=PE_TOL)


@pytest.mark.parametrize("source", ["sam_torch", "jax"])
def test_decode_points_matches_jax(source):
    """``SAM.forward`` = encode, then ``decode_points`` with the padding point:
    masks (B, 4, 24, 24) and IoU (B, 4) against JAX's; the port's embedding of
    batch 1 broadcast over the prompts gives the same as JAX's repeated one."""
    sources, _ = _sources()
    jvars, model = sources[source]
    img, (pts, lbl) = _image(), _prompts()
    B = pts.shape[0]
    jm = jsam.SAM(variant="vit_b", img_size=IMG)
    emb = _jax_encode()(jvars, jnp.asarray(img))
    j_masks, j_iou = jax.jit(functools.partial(jm.apply, method=jsam.SAM.decode_points))(
        jvars, jnp.repeat(emb, B, axis=0), jnp.asarray(pts), jnp.asarray(lbl))
    x = torch.from_numpy(img).permute(0, 3, 1, 2)
    masks, iou = model.decode_points(model.encode_image(x), torch.from_numpy(pts), torch.from_numpy(lbl).long())
    assert tuple(masks.shape) == (B, 4, 4 * IMG // 16, 4 * IMG // 16) and tuple(iou.shape) == (B, 4)
    np.testing.assert_allclose(iou.numpy(), np.asarray(j_iou), rtol=IOU_RTOL, atol=IOU_ATOL)
    np.testing.assert_allclose(masks.numpy(), np.asarray(j_masks), rtol=MASK_RTOL, atol=MASK_ATOL)
    whole = model(x.expand(B, -1, -1, -1), torch.from_numpy(pts), torch.from_numpy(lbl).long())
    np.testing.assert_allclose(whole[0].numpy(), masks.numpy(), rtol=0, atol=1e-5)


def test_decode_points_matches_sam_torch():
    sources, ref = _sources()
    img, (pts, lbl) = _image(5), _prompts(6, B=2, P=2)
    x = torch.from_numpy(img).permute(0, 3, 1, 2).expand(2, -1, -1, -1)
    want = ref.forward_points(x, torch.from_numpy(pts), torch.from_numpy(lbl).long())
    got = sources["sam_torch"][1](x, torch.from_numpy(pts), torch.from_numpy(lbl).long())
    np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), rtol=IOU_RTOL, atol=IOU_ATOL)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=MASK_RTOL, atol=MASK_ATOL)


def test_export_is_the_inverse_of_the_jax_converter():
    """``convert_sam_state_dict(export_sam_state_dict(v))`` gives ``v`` back bit for
    bit, every leaf placed (the ConvTranspose flip undone exactly); the exported
    keys are the released layout's (``sam_torch.py``'s) and the port's."""
    seeded = _seeded_variables()
    sd = export_sam_state_dict(seeded)
    back, report = jconv.convert_sam_state_dict(sd, _template(), strict=True)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(seeded),
                                 jax.tree_util.tree_leaves_with_path(jax.device_get(back))):
        np.testing.assert_array_equal(np.asarray(b), a, err_msg=jax.tree_util.keystr(path))
    ref_keys = set(RefSam(variant="vit_b", img_size=IMG).state_dict())
    assert set(sd) == ref_keys == set(psam.SAM("vit_b", img_size=IMG).state_dict())
    up = seeded["params"]["mask_decoder"]["up1"]["kernel"]                     # (2, 2, 256, 64), flax
    assert sd["mask_decoder.output_upscaling.0.weight"].shape == (256, 64, 2, 2)
    np.testing.assert_array_equal(sd["mask_decoder.output_upscaling.0.weight"][:, :, 0, 1], up[1, 0])
    assert sam_flax_path_to_torch_key(("mask_decoder", "iou_token")) == "mask_decoder.iou_token.weight"
    assert sam_flax_path_to_torch_key(("image_encoder", "block_3", "mlp_fc2", "bias")) == \
        "image_encoder.blocks.3.mlp.lin2.bias"
    assert sam_flax_path_to_torch_key(("mask_decoder", "layers_1", "mlp_lin1", "kernel")) == \
        "mask_decoder.transformer.layers.1.mlp.lin1.weight"


def test_load_is_strict():
    _, model = _sources()[0]["jax"]
    sd = export_sam_state_dict(_seeded_variables())
    with pytest.raises(ValueError, match="image_encoder.blocks.0.attn.rel_pos_h"):
        load_sam_state_dict(model, {k: v for k, v in sd.items() if k != "image_encoder.blocks.0.attn.rel_pos_h"})
    with pytest.raises(ValueError, match="mask_decoder.extra"):
        load_sam_state_dict(model, {**sd, "mask_decoder.extra": np.zeros(1, np.float32)})


def test_interpolation_matches_jax_helpers():
    rng = np.random.default_rng(3)
    rel = rng.normal(0, 1, size=(127, 64)).astype(np.float32)          # a global table at 1024²
    np.testing.assert_allclose(resize_sam_rel_pos(rel, 11), jconv._sam_resize_rel_pos(rel, 11), rtol=0, atol=1e-6)
    pos = rng.normal(0, 1, size=(1, 64, 64, 32)).astype(np.float32)
    np.testing.assert_allclose(resize_sam_pos_embed(pos, (1, 6, 6, 32)),
                               jconv._sam_resize_pos_embed(pos, (1, 6, 6, 32)), rtol=0, atol=1e-6)


def test_released_geometry_checkpoint_loads_at_another_size(tmp_path):
    """A checkpoint with 1024²'s ``pos_embed`` (64×64) and global rel-pos tables
    (127 rows) through ``build_sam(checkpoint=..., img_size=96)``: the warning, and
    the tables the JAX package's converter makes of it, within 1e-6."""
    rng = np.random.default_rng(7)
    sd = export_sam_state_dict(_seeded_variables(1))
    sd["image_encoder.pos_embed"] = rng.normal(0, 0.1, (1, 64, 64, 768)).astype(np.float32)
    for i in (2, 5, 8, 11):
        for t in ("h", "w"):
            sd[f"image_encoder.blocks.{i}.attn.rel_pos_{t}"] = rng.normal(0, 0.2, (127, 64)).astype(np.float32)
    path = tmp_path / "sam_vit_b.pth"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    with pytest.warns(UserWarning, match="interpolated"):
        model = psam.build_sam("vit_b", checkpoint=str(path), img_size=IMG, device="cpu")
    jvars, _ = jconv.convert_sam_state_dict(sd, _template(), strict=True)
    enc = jvars["params"]["image_encoder"]
    own = model.image_encoder
    np.testing.assert_allclose(own.pos_embed.detach().numpy(), np.asarray(enc["pos_embed"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(own.blocks[5].attn.rel_pos_w.detach().numpy(),
                               np.asarray(enc["block_5"]["attn"]["rel_pos_w"]), rtol=0, atol=1e-6)
    assert own.blocks[5].attn.rel_pos_w.shape == (11, 64) and own.blocks[0].attn.rel_pos_h.shape == (27, 64)


def test_bf16_model_computes_in_bf16():
    """``dtype=torch.bfloat16``: linear and convolution weights in bf16, LayerNorms,
    ``pos_embed`` and the tokens fp32 (flax's parameters); the embedding, masks and
    IoU come out bf16.  Each of the three, against the JAX package's
    ``SAM(dtype=bfloat16)`` on the same variables, by ``tests/test_torch_bf16.py``'s
    rule: no farther from JAX fp32 than ``BF16_RULE`` × JAX bf16's distance, and at
    least half that distance from the port's own fp32 output (it does round).
    32 prompts: the rule compares mean distances, and 3 prompts' 12 IoU values
    are too few for a mean (their reading moved from 0.9 to 1.7 of JAX's with
    torch's thread count alone)."""
    variables = _seeded_variables()
    sd = export_sam_state_dict(variables)
    img, (pts, lbl) = _image(), _prompts(B=32)
    B = pts.shape[0]
    models = {}
    for dtype in (torch.float32, torch.bfloat16):
        models[dtype] = psam.SAM("vit_b", img_size=IMG, dtype=dtype)
        load_sam_state_dict(models[dtype], sd)
    m16 = models[torch.bfloat16]
    enc = m16.image_encoder
    assert enc.blocks[0].attn.qkv.weight.dtype == torch.bfloat16 and enc.neck[0].weight.dtype == torch.bfloat16
    assert enc.blocks[0].norm1.weight.dtype == enc.pos_embed.dtype == m16.mask_decoder.iou_token.weight.dtype \
        == torch.float32
    x = torch.from_numpy(img).permute(0, 3, 1, 2)
    outs = {}
    for dtype, model in models.items():
        emb = model.encode_image(x)
        outs[dtype] = (emb, *model.decode_points(emb, torch.from_numpy(pts), torch.from_numpy(lbl).long()))
    jax_outs = {}
    for dtype in (jnp.float32, jnp.bfloat16):
        jm = jsam.SAM(variant="vit_b", img_size=IMG, dtype=dtype)
        emb = jax.jit(functools.partial(jm.apply, method=jsam.SAM.encode_image))(variables, jnp.asarray(img))
        masks, iou = jax.jit(functools.partial(jm.apply, method=jsam.SAM.decode_points))(
            variables, jnp.repeat(emb, B, axis=0), jnp.asarray(pts), jnp.asarray(lbl))
        jax_outs[dtype] = [np.asarray(a, np.float32) for a in (emb.transpose(0, 3, 1, 2), masks, iou)]
    for name, got, own32, j32, j16 in zip(("embedding", "masks", "iou"), outs[torch.bfloat16], outs[torch.float32],
                                          jax_outs[jnp.float32], jax_outs[jnp.bfloat16]):
        assert got.dtype == torch.bfloat16, name
        got = got.float().numpy()
        e_jax, e_port = np.abs(j16 - j32).mean(), np.abs(got - j32).mean()
        assert 0 < e_jax and e_port <= BF16_RULE * e_jax, (name, e_port, e_jax)
        assert np.abs(got - own32.numpy()).mean() >= 0.5 * e_jax, name


def test_bf16_rounds_where_flax_rounds():
    """Every module's output type in the bf16 model is the type of the matching
    flax module's output in the JAX package's bf16 ``SAM`` (its
    ``capture_intermediates``): the encoder's residual stream fp32 (flax adds the
    fp32 ``pos_embed``), LayerNorm, Dense and Conv outputs bf16, the decoder's
    blocks bf16.  The mean-distance rule above cannot see one misplaced rounding."""
    B = 3
    img, (pts, lbl) = np.repeat(_image(), B, axis=0), _prompts(B=B)
    jm = jsam.SAM(variant="vit_b", img_size=IMG, dtype=jnp.bfloat16)
    _, state = jax.eval_shape(
        lambda v: jm.apply(v, jnp.asarray(img), jnp.asarray(pts), jnp.asarray(lbl),
                           capture_intermediates=True, mutable=["intermediates"]), _seeded_variables())
    want = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(state["intermediates"]):
        mods = tuple(k.key for k in path if isinstance(k, jax.tree_util.DictKey) and k.key != "__call__")
        want.setdefault(sam_flax_path_to_torch_key(mods + ("x",))[:-2], []).append(str(leaf.dtype))
    model = psam.SAM("vit_b", img_size=IMG, dtype=torch.bfloat16)
    load_sam_state_dict(model, export_sam_state_dict(_seeded_variables()))
    got, hooks = {}, []
    for name, mod in model.named_modules():
        if name in want:
            hooks.append(mod.register_forward_hook(
                lambda m, a, out, name=name: got.setdefault(name, []).extend(
                    str(t.dtype).replace("torch.", "") for t in (out if isinstance(out, tuple) else (out,)))))
    model(torch.from_numpy(img).permute(0, 3, 1, 2), torch.from_numpy(pts), torch.from_numpy(lbl).long())
    for h in hooks:
        h.remove()
    assert got == {k: v for k, v in want.items() if k in got}
    for name in ("image_encoder.blocks.0", "image_encoder.blocks.11.norm2", "image_encoder.neck.3",
                 "mask_decoder.transformer.layers.1", "mask_decoder.output_upscaling.1",
                 "mask_decoder.iou_prediction_head.layers.2", "mask_decoder.output_hypernetworks_mlps.3.layers.0"):
        assert name in got, name
    assert got["image_encoder.blocks.0"] == ["float32"] and got["image_encoder.blocks.0.norm1"] == ["bfloat16"]
    assert len(got) > 0.9 * len(want), sorted(set(want) - set(got))


def test_entry_points_pick_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        psam.build_sam("vit_b", img_size=32)
    assert next(psam.build_sam("vit_b", img_size=32, device="cpu").parameters()).device.type == "cpu"
    assert sorted(psam.sam_model_registry) == sorted(jsam.sam_model_registry) == ["vit_b", "vit_h", "vit_l"]
