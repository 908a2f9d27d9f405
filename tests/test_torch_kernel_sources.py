"""The text changes of the kernel tools hold on the CUDA sources.

``ecwam_tpu_torch/tools/mutations.py`` (broken copies of the kernels, read
against the card limits), ``tools/advect_stages.py`` and
``tools/implsch_stages.py`` (copies with a stage taken out, timed apart)
each build copies of a ``csrc/*.cu`` source with text changes.  A change
whose text no longer occurs exactly once in its source shows only on the
card; these tests read the sources here, with neither JAX nor a card.
"""

import os

import pytest

from ecwam_tpu_torch.tools import advect_stages, implsch_stages, mutations

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "ecwam_tpu_torch", "csrc")


def source(name: str) -> str:
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


BROKEN = sorted(n for n, m in mutations.MUTATIONS.items() if m[1])


@pytest.mark.parametrize("name", BROKEN)
def test_mutation_text_occurs_once_and_changes(name):
    kinds, src, text, repl = mutations.MUTATIONS[name]
    assert source(src).count(text) == 1
    assert repl != text
    assert kinds and set(kinds) <= set(mutations.KINDS)


def test_every_check_kind_is_read_and_the_sound_copy_reads_all():
    assert set(mutations.CHECKS) == set(mutations.KINDS)
    kinds, src, text, repl = mutations.MUTATIONS["sound"]
    assert set(kinds) == set(mutations.KINDS) and src is None
    # every kind but the sound copy's own has a broken copy to catch
    covered = {k for n in BROKEN for k in mutations.MUTATIONS[n][0]}
    assert covered == set(mutations.KINDS)


STAGES = ([("advect", n) for n in sorted(advect_stages.VARIANTS)]
          + [("implsch", n) for n in sorted(implsch_stages.VARIANTS)])


@pytest.mark.parametrize("tool,name", STAGES)
def test_stage_changes_apply_to_the_kernel(tool, name):
    variants = (advect_stages.VARIANTS if tool == "advect"
                else implsch_stages.VARIANTS)
    changes = variants[name]
    src = source(f"{tool}.cu")
    if name == "sound":
        assert changes == ()
        return
    assert changes and all(old != new for old, new in changes)
    out = src
    for old, new in changes:
        assert out.count(old) == 1, old[:60]
        out = out.replace(old, new)
    assert out != src
