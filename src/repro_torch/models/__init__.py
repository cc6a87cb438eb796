"""Port of ``repro.models``: the LM tree (config, layers, linear attention,
mamba, rwkv6, moe, transformer, encdec, frontends), plus ``convert``, which
carries the reference's weights and caches into the port's layouts."""
