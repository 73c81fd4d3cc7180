"""Rank functions of ``tests/test_torch_tp_heads.py`` for
``test_torch_gloo_ranks.run_ranks`` (torch only, no JAX: the spawned
ranks import this module, not the test file)."""
import torch


def tied_vocab_rank(group, rank, arch, over, tree, tokens, nxt, max_len):
    """Rank ``rank``'s reduced ``arch`` on ``tree`` (whole latent params in
    ``repro``'s layout, as numpy; cut by ``tp.shard_params``): the embedded
    rows of ``tokens`` through its split table, the prefill's last logits
    and the logits of a decode step of ``nxt``, all in the group, as f32
    numpy (a torch tensor would cross the queue through a file descriptor
    that the rank's exit can close before the caller reads it)."""
    from repro_torch.checkpoint.convert import params_from_numpy
    from repro_torch.configs import get_config
    from repro_torch.distributed import tp as tp_lib
    from repro_torch.models import LM, layers
    from repro_torch.models.transformer import param_specs

    cfg = get_config(arch, reduced=True, **over)
    params = params_from_numpy(tree, cfg, "cpu")
    shards = tp_lib.shard_params(params, param_specs(cfg, params),
                                 {"model": group.size}, rank=rank, cfg=cfg,
                                 latent=True)
    model = LM(tp_lib.local_config(cfg, group.size, rank), "cpu")
    model.comm = group
    toks = torch.as_tensor(tokens)
    with torch.no_grad():
        with tp_lib.bound(group):
            rows = layers.embed_apply(shards["embed"], toks, cfg)
        cache, logits = model.prefill(shards, {"tokens": toks}, max_len)
        step, _ = model.decode_step(shards, cache,
                                    torch.as_tensor(nxt)[:, None])
    return {"rows": rows.float().numpy(),
            "prefill": logits[:, -1].float().numpy(),
            "decode": step[:, 0].float().numpy(),
            "table": shards["embed"]["tp"],
            "table_rows": shards["embed"]["table"].shape[0]}
