"""``vil_tpu_torch.config`` against ``vil_tpu.config``: the default tree, the
repository's yaml files, dotted overrides, unknown keys and ``dump`` give
the same trees in both packages (compared exactly, types included); and
``train.trainer.check_ported`` refuses every key that selects what the port
lacks, naming its ROADMAP item, and accepts the attention families."""
import os

import pytest
import yaml

from vil_tpu.config import get_default_cfg as jax_default_cfg
from vil_tpu_torch.config import CfgNode, get_default_cfg
from vil_tpu_torch.train.trainer import check_ported

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = ("configs/msvit.yaml", "configs/msvit_384finetune.yaml")


def _typed(tree):
    """The tree with every leaf paired with its type, so that 1 != 1.0 and
    a tuple != a list."""
    if isinstance(tree, dict):
        return {k: _typed(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, [_typed(v) for v in tree])
    return (type(tree).__name__, tree)


def _both(fn):
    ours, theirs = get_default_cfg(), jax_default_cfg()
    fn(ours)
    fn(theirs)
    return ours, theirs


def test_default_trees_are_equal():
    assert _typed(get_default_cfg().to_dict()) == _typed(jax_default_cfg().to_dict())


@pytest.mark.parametrize("path", YAMLS)
def test_yaml_merges_to_equal_trees(path):
    ours, theirs = _both(lambda c: c.merge_from_file(os.path.join(REPO, path)))
    assert _typed(ours.to_dict()) == _typed(theirs.to_dict())
    assert ours.to_dict() != get_default_cfg().to_dict()  # the file changed something


@pytest.mark.parametrize("key,value", [
    ("OPTIM.LR", "5e-4"),                   # literal → float
    ("OPTIM.EPOCHS", "3"),
    ("OPTIM.WD", "0"),                      # int onto a float default → float
    ("TPU.USE_PALLAS", "0"),                # int onto a bool default → bool
    ("DATA.TRAIN", "('synthetic',)"),       # tuple
    ("AUG.SCALE", "[0.5, 1.0]"),            # list onto a tuple default → tuple
    ("INPUT.MEAN", "(0.5, 0.5, 0.5)"),      # tuple onto a list default → list
    ("MODEL.VIT.MSVIT.ARCH", "l1,h1,d16,n1,s1,g1,p4,f2_l2,h2,d32,n1,s0,g0,p2,f2"),
    ("AUG.TIMM_AUG.AUTO_AUGMENT", "rand-m9-mstd0.5-inc1"),  # a new key where allowed
    ("MODEL.MODEL_PATH", "/x/y.pth"),
])
def test_merge_from_list_coerces_alike(key, value):
    ours, theirs = _both(lambda c: c.merge_from_list([key, value]))
    assert _typed(ours.to_dict()) == _typed(theirs.to_dict())


@pytest.mark.parametrize("how", ["list", "file", "attribute"])
def test_unknown_key_raises_in_both(how, tmp_path):
    bad = tmp_path / "bad.yaml"
    bad.write_text("OPTIM:\n  NOT_A_KEY: 1\n")
    for cfg in (get_default_cfg(), jax_default_cfg()):
        with pytest.raises(KeyError, match="NOT_A_KEY"):
            if how == "list":
                cfg.merge_from_list(["OPTIM.NOT_A_KEY", "1"])
            elif how == "file":
                cfg.merge_from_file(str(bad))
            else:
                cfg.OPTIM.NOT_A_KEY = 1


@pytest.mark.parametrize("path", ("",) + YAMLS)
def test_dump_round_trips(path):
    ours = get_default_cfg()
    if path:
        ours.merge_from_file(os.path.join(REPO, path))
    ours.merge_from_list(["DATA.TRAIN", "('a', 'b')", "OPTIM.LR", "0.1"])
    back = get_default_cfg()
    back._merge_dict(yaml.safe_load(ours.dump()))
    assert _typed(back.to_dict()) == _typed(ours.to_dict())
    theirs = jax_default_cfg()
    if path:
        theirs.merge_from_file(os.path.join(REPO, path))
    theirs.merge_from_list(["DATA.TRAIN", "('a', 'b')", "OPTIM.LR", "0.1"])
    assert ours.dump() == theirs.dump()


def test_freeze_and_clone():
    cfg = get_default_cfg()
    cfg.freeze()
    with pytest.raises(AttributeError, match="immutable"):
        cfg.OPTIM.LR = 0.1
    clone = cfg.clone()
    clone.OPTIM.LR = 0.1
    assert cfg.OPTIM.LR == 1.0 and isinstance(clone, CfgNode)
    cfg.defrost()
    cfg.OPTIM.LR = 0.2
    assert cfg.OPTIM.LR == 0.2


@pytest.mark.parametrize("key,value,item", [
    ("TPU.PARAM_SHARDING", "fsdp", "A12"),
    ("TPU.PARAM_SHARDING", "tp", "A12"),
    ("TPU.MESH_AXES", "['data', 'spatial']", "A12"),
    ("TPU.MESH_AXES", "['data', 'model']", "A12"),
    ("TPU.MESH_SHAPE", "[4]", "A12"),
    ("CKPT_BACKEND", "orbax", "A6"),
    ("DATALOADER.BACKEND", "grain", "A6"),
    ("MODEL.ARCH", "resnet50", "A10"),
    ("TPU.REMAT", "full", "A13"),
    ("TPU.FLAT_OPT", "True", "A13"),
])
def test_unported_keys_raise_naming_their_item(key, value, item):
    cfg = get_default_cfg()
    check_ported(cfg)
    cfg.merge_from_file(os.path.join(REPO, YAMLS[0]))
    check_ported(cfg)
    cfg.merge_from_list([key, value])
    with pytest.raises(NotImplementedError, match=f"{item}.*ROADMAP"):
        check_ported(cfg)


@pytest.mark.parametrize("key,value,attn", [
    ("MODEL.VIT.MSVIT.ATTN_TYPE", "performer", "PerformerAttention"),
    ("MODEL.VIT.MSVIT.ATTN_TYPE", "linformer", "LinformerAttention"),
    ("MODEL.VIT.MSVIT.ONLY_GLOBAL", "True", "VilAttention"),
    ("MODEL.VIT.MSVIT.SHARE_W", "False", "VilAttention"),
])
def test_attention_family_keys_are_accepted_and_build(key, value, attn):
    """The paper's other attention families: ``check_ported`` accepts the
    key over configs/msvit.yaml, and ``build_model`` builds it (at a narrow
    width) with the family's module in the sparse stages."""
    from vil_tpu_torch.models import build_model

    cfg = get_default_cfg()
    cfg.merge_from_file(os.path.join(REPO, YAMLS[0]))
    arch = "l1,h1,d16,n1,s1,g1,p4,f4_l2,h2,d32,n1,s1,g1,p2,f4_l3,h2,d32,n1,s0,g0,p2,f4"
    cfg.merge_from_list([key, value, "MODEL.VIT.MSVIT.ARCH", arch, "INPUT.IMAGE_SIZE", "32",
                         "DATA.NUM_CLASSES", "10"])
    check_ported(cfg)
    attn_mod = build_model(cfg, device="cpu").stage1_block0_attn.attn
    assert type(attn_mod).__name__ == attn
    assert getattr(attn_mod, "only_glo", False) == (key.endswith("ONLY_GLOBAL"))
    assert hasattr(attn_mod, "kv_global") == (key.endswith("SHARE_W"))
