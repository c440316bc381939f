"""The launcher's engine-config flags against the JAX launcher's mapping.

``--kv-cache-block-size``, ``--num-pages``, ``--max-batch-size``,
``--prefill-token-budget``, ``--spec-decode`` and ``--spec-tokens`` are
the JAX launcher's flags (``dynamo_tpu/run.py`` parse_args); its
``_jax_engine_setup`` maps them onto its EngineConfig (page size, with the
prefill chunk rounded down to a multiple of it and at least one page;
pages; batch rows; the prefill token budget; speculative decoding and
its draft length). The port's ``build_engine_config`` must give the same
fields for the same command line, on the tiny preset's config and on the
default one; a value the config refuses is refused by both. The flags
that do not touch the engine config (``--context-length``,
``--max-tokens``, ``--profile-dir``, and ``--sequence-parallel-size`` and
``--dp-replicas`` at their defaults) leave it the JAX launcher's too.
"""

import pytest

from dynamo_tpu import run as jax_run
from dynamo_tpu_torch import run

FIELDS = ("page_size", "num_pages", "max_batch", "prefill_chunk",
          "prefill_buckets", "batch_buckets", "page_buckets",
          "prefill_token_budget", "spec_decode", "spec_tokens",
          "prefill_priority", "spec_ngram_max", "spec_ngram_min")

FLAGS = [[], ["--kv-cache-block-size", "8"], ["--kv-cache-block-size", "48"],
         ["--kv-cache-block-size", "1000"], ["--num-pages", "300"],
         ["--max-batch-size", "4"],
         ["--kv-cache-block-size", "4", "--num-pages", "64",
          "--max-batch-size", "2"],
         ["--prefill-token-budget", "256"], ["--spec-decode"],
         ["--spec-decode", "--spec-tokens", "2"], ["--spec-tokens", "7"],
         ["--spec-decode", "--spec-tokens", "4", "--prefill-token-budget",
          "256"],
         # flags that leave the engine config as it is: the card's context
         # length, the text and batch modes' cap, the trace directory, and
         # the unported features' flags at their defaults
         ["--context-length", "4096", "--max-tokens", "32", "--profile-dir",
          "trace"],
         ["--sequence-parallel-size", "1", "--dp-replicas", "1",
          "--max-batch-size", "4"]]


@pytest.mark.parametrize("model", [[], ["--model", "1b"], ["--model", "8b"]],
                         ids=["tiny", "1b", "8b"])
@pytest.mark.parametrize("flags", FLAGS, ids=[" ".join(f) or "none"
                                              for f in FLAGS])
def test_engine_config_flags_map_as_the_jax_launcher(model, flags):
    want = jax_run._jax_engine_setup(
        jax_run.parse_args(["in=http", "out=jax", *model, *flags]))[1]
    got = run.build_engine_config(
        run.parse_args(["in=http", "out=torch", *model, *flags]))
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), f


def test_flags_parse_and_default_to_none():
    args = run.parse_args(["in=http", "out=torch"])
    assert (args.kv_cache_block_size, args.num_pages,
            args.max_batch_size) == (None, None, None)
    args = run.parse_args(["in=http", "out=torch", "--kv-cache-block-size",
                           "8", "--num-pages", "1024", "--max-batch-size",
                           "4"])
    assert (args.kv_cache_block_size, args.num_pages,
            args.max_batch_size) == (8, 1024, 4)


def test_max_batch_size_cuts_the_warmed_decode_grid():
    """--max-batch-size 4 on the default config (phases 7 and 8 of
    chip_smoke.py start the tensor-parallel ranks so) warms decode
    batches 1, 2 and 4 where the default warms seven; its prefill
    batches are 1 and 4 (for 8), as many as before."""
    full = run.build_engine_config(run.parse_args(
        ["in=http", "out=torch", "--model", "8b"])).warmed_grid()
    cut = run.build_engine_config(run.parse_args(
        ["in=http", "out=torch", "--model", "8b", "--max-batch-size",
         "4"])).warmed_grid()
    assert full["decode_batches"] == [1, 2, 4, 8, 16, 32, 64]
    assert cut["decode_batches"] == [1, 2, 4]
    assert full["prefill_batches"] == [1, 8]
    assert cut["prefill_batches"] == [1, 4]
    assert cut["prefill_lens"] == full["prefill_lens"]
    assert cut["page_buckets"] == full["page_buckets"]


def test_spec_flags_parse_and_default_as_the_jax_launcher():
    """The three scheduler flags' defaults are the JAX launcher's (off,
    4, None), and ``--spec-tokens 0`` with ``--spec-decode`` is refused by
    both configs."""
    args = run.parse_args(["in=http", "out=torch"])
    jargs = jax_run.parse_args(["in=http", "out=jax"])
    assert (args.spec_decode, args.spec_tokens, args.prefill_token_budget) \
        == (jargs.spec_decode, jargs.spec_tokens,
            jargs.prefill_token_budget) == (False, 4, None)
    flags = ["--spec-decode", "--spec-tokens", "0"]
    with pytest.raises(ValueError, match="spec_tokens"):
        jax_run._jax_engine_setup(
            jax_run.parse_args(["in=http", "out=jax", *flags]))
    with pytest.raises(ValueError, match="spec_tokens"):
        run.build_engine_config(
            run.parse_args(["in=http", "out=torch", *flags]))
