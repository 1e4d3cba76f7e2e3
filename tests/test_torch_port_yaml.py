"""YAML configs against soar_tpu and PyYAML on the CPU: the port's own
reader (``soar_tpu_torch.io.yaml_subset``; the card has no PyYAML) equals
``yaml.safe_load`` on the repo's configs, on a document with the
reference's constructs and on each scalar form; it refuses what lies
outside its subset with the line; ``load_yaml_config`` and the CLI's
precedence helpers equal the JAX package's.  Every comparison is exact."""

import dataclasses
import math
import os

import pytest
import yaml

from soar_tpu.cli import train as jcli
from soar_tpu.train.yaml_config import load_yaml_config as jload
from soar_tpu_torch.cli import train as tcli
from soar_tpu_torch.io import yaml_subset
from soar_tpu_torch.train.yaml_config import load_yaml_config as tload

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ("configs/surfel_stage0.yaml", "configs/surfel_stage1.yaml")


def same(a, b):
    """Equal values and equal types all the way down (True != 1 here)."""
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("path", CONFIGS)
def test_reader_equals_safe_load_on_the_configs(path):
    path = os.path.join(REPO, path)
    with open(path) as f:
        assert same(yaml_subset.load_file(path), yaml.safe_load(f))


# The reference's constructs (threestudio configs): nested maps, flow lists
# of mixed int/float, ???, OmegaConf interpolations, 1e-4 (a string in
# YAML 1.1), 0.0001, quoted strings, comments, block lists in every form.
REFERENCE_STYLE = r"""
# threestudio-style config
name: "gaussiansurfel-imagedream"   # trailing comment
tag: "${rmspace:${system.prompt_processor.prompt},_}"
exp_root_dir: "outputs"
seed: 0
data_type: "mvdream-random-multiview-camera-datamodule"
data:
  image_path: ???
  tag: ${basename:${data.image_path}}
  batch_size: [1, 1]
  n_view: 4
  width: 512
  height: 512
  resolution_milestones: [1000]
  elevation_range: [-10, 45.5]
  fovy_range: [15, 60]
  camera_distance_range: [0.8, 1.0]
  rays_d_normalize: false
system_type: "gaussiansurfel-mvdream-system"
system:
  training_stage: 0
  guidance_type: "imagedream-multiview-diffusion-guidance"
  geometry:
    position_lr_init: 0.000016
    scale_lr: 1e-4
    feature_lr: 0.01
    opacity_lr: 1.0e-2
    empty:
    nothing: ~
    flag: yes
    off_flag: off
  loss:
    lambda_sds: [0, 0.1, 0.01, 1000]
    lambda_tv_loss: 1.
    lambda_depth_tv_loss: 0
  prompt_processor:
    prompt: ???
    negative_prompt: 'ugly, it''s # not a comment'
    front_threshold: 30.
  exporter:
    save_uv: true
    fmt: "obj\t#"
  milestones:
  - 1_000
  - [2, 3]
  - {a: 1, 'b': [x, y], c: }
  - key: v
    other: 0x1F
  - - nested
    - 017
  -
    deep: [a,
      b, c]
trainer:
  max_steps: 5000
  log_every_n_steps: 1
  precision: 16-mixed
  url: http://host/path#frag
checkpoint:
  every_n_train_steps: ${trainer.max_steps}
"""


def test_reader_equals_safe_load_on_reference_constructs():
    assert same(yaml_subset.load(REFERENCE_STYLE), yaml.safe_load(REFERENCE_STYLE))


SCALARS = ["1e-4", "0.0001", "1.0e-4", "1.0e4", "1.5E+3", "3e5", "1_000", "1_000.5", "017",
           "08", "0x1F", "0b101", "-0x1f", "+12", "-3", "0", "-0", "00", "0.", "-.5",
           "1:30", "1:30.5", ".inf", "-.Inf", ".nan", "true", "True", "TRUE", "yes", "no",
           "on", "Off", "y", "n", "~", "null", "NULL", "", "???",
           "${basename:${data.image_path}}", "a b  c", "a#b", "'q'", '"d\\n\\u00e9"', "''",
           "'it''s'", "http://x.y/z", "a:b", "--", "-a", "[]", "{}",
           "[1, 2.0, '3', yes, ~]", "{a: 1, b: [2, 3.5], 'c': {d: e}}", "[1, 2,]"]


@pytest.mark.parametrize("value", SCALARS)
def test_values_resolve_as_safe_load(value):
    """As a mapping value, a sequence item and a flow item; where PyYAML
    refuses the document (``[???]``: '?' opens a key in a flow), so does
    the reader."""
    for src in (f"k: {value}\n", f"- {value}\n", f"[{value}]\n" if value else "[~]\n"):
        try:
            want = yaml.safe_load(src)
        except yaml.YAMLError:
            with pytest.raises(ValueError, match="line 1"):
                yaml_subset.load(src)
            continue
        assert same(yaml_subset.load(src), want), src


@pytest.mark.parametrize("src, line, what", [
    ("a: 1\nb: &anchor 2\n", 2, "anchor"),
    ("a: 1\nb: *ref\n", 2, "alias"),
    ("a:\n  b: !!str 1\n", 2, "tag"),
    ("a: 1\nb: |\n  text\n", 2, "block scalar"),
    ("a: >\n  folded\n", 1, "block scalar"),
    ("a: 1\n---\nb: 2\n", 2, "second document"),
    ("? a\n: b\n", 1, "explicit key"),
    ("a:\n  <<: {x: 1}\n", 2, "merge key"),
    ("a: [!!int 1]\n", 1, "tag"),
    ("a: one\n  two\n", 2, "continued"),
    ("a: 2001-12-14\n", 1, "timestamp"),
    ("%YAML 1.1\n---\na: 1\n", 1, "directive"),
])
def test_refuses_what_lies_outside_the_subset(src, line, what):
    with pytest.raises(ValueError, match=f"line {line}: .*{what}"):
        yaml_subset.load(src)


def _assert_dataclass_equal(got, want, path):
    assert type(got).__name__ == type(want).__name__, path
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(w):
            _assert_dataclass_equal(g, w, f"{path}.{f.name}")
        else:
            assert g == w and type(g) is type(w), (f"{path}.{f.name}", g, w)


def _assert_config_equal(got, want):
    for key in ("train", "stage", "guidance"):
        _assert_dataclass_equal(got[key], want[key], key)
    for key in ("guidance_kind", "guidance_ckpt", "prompt", "negative_prompt", "dataroot"):
        assert got[key] == want[key], key
    assert same(got["raw"], want["raw"])


@pytest.mark.parametrize("path", CONFIGS)
def test_load_yaml_config_matches_jax(path):
    path = os.path.join(REPO, path)
    _assert_config_equal(tload(path), jload(path))


def test_load_yaml_config_reference_layout_matches_jax(tmp_path):
    """The aliases (lambda_tv_loss, lambda_depth_tv_loss), scale_lr left
    unmapped, a scheduled lambda, the guidance kind and the string 1e-4."""
    path = str(tmp_path / "ref.yaml")
    with open(path, "w") as f:
        f.write(REFERENCE_STYLE.replace("    empty:\n    nothing: ~\n    flag: yes\n"
                                        "    off_flag: off\n", ""))
    got, want = tload(path), jload(path)
    _assert_config_equal(got, want)
    assert got["guidance_kind"] == "imagedream"
    assert got["stage"].loss.tv == 1.0 and got["stage"].loss.sds == (0, 0.1, 0.01, 1000)
    assert got["train"].optim.scaling_lr == 0.005  # scale_lr is a dead knob
    assert got["raw"]["system"]["geometry"]["scale_lr"] == "1e-4"


def test_resolve_cli_stage_matches_jax(capsys):
    yaml_cfg = (tload(os.path.join(REPO, CONFIGS[1])), jload(os.path.join(REPO, CONFIGS[1])))
    for arg in ("both", "0", "1", None):
        for t_cfg, j_cfg in ((yaml_cfg[0], yaml_cfg[1]), (None, None)):
            assert tcli.resolve_cli_stage(arg, t_cfg) == jcli.resolve_cli_stage(arg, j_cfg)
    assert tcli.resolve_cli_stage(None, yaml_cfg[0]) == "1"
    assert tcli.resolve_cli_stage(None, None) == "both"
    assert "--config defines stage 1" in capsys.readouterr().out


def test_resolve_stage_cfg_matches_jax():
    t0, j0 = (f(os.path.join(REPO, CONFIGS[0])) for f in (tload, jload))
    for t_cfg, j_cfg in ((t0, j0), (None, None)):
        for st in (0, 1):
            for steps in (None, 600):
                _assert_dataclass_equal(tcli.resolve_stage_cfg(t_cfg, st, steps),
                                        jcli.resolve_stage_cfg(j_cfg, st, steps),
                                        f"stage {st} steps {steps}")
    assert tcli.resolve_stage_cfg(t0, 0, None).max_steps == 1000
    assert tcli.resolve_stage_cfg(t0, 0, 600).max_steps == 600
    assert tcli.resolve_stage_cfg(None, 1, 250).max_steps == 250


def test_resolve_guidance_kind_matches_jax(capsys):
    kw = dict(ckpt=None, embeddings=None, clip_dir=None, mock=False)
    cases = [("imagedream", True, kw), ("none", False, kw), ("none", True, kw),
             ("imagedream", True, dict(kw, mock=True)),
             ("mvdream", False, dict(ckpt="x.pt", embeddings="p.npz", clip_dir=None,
                                     mock=False)),
             ("mvdream", True, dict(kw, ckpt="x.pt"))]
    for kind, from_yaml, k in cases:
        assert (tcli.resolve_guidance_kind(kind, from_yaml, **k)
                == jcli.resolve_guidance_kind(kind, from_yaml, **k))
    assert "WITHOUT SDS guidance" in capsys.readouterr().out
    for mod in (tcli, jcli):
        with pytest.raises(SystemExit, match="guidance-ckpt"):
            mod.resolve_guidance_kind("imagedream", False, **kw)


def test_cli_config_needs_a_capture_or_synthetic(tmp_path):
    """--config alone (its dataroot is ???) stops as the JAX CLI does."""
    out = str(tmp_path / "run")
    for mod in (tcli, jcli):
        with pytest.raises(SystemExit, match="dataroot"):
            mod.main(["--config", os.path.join(REPO, CONFIGS[1]), "--out", out])
