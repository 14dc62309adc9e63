"""A tiny size of the benchmark's configurations and traffic, for runs of
the harness on the CPU in the tests: 2 layers, d_model 64; and the cells
that are built but not yet in ``BENCHMARK.json`` (PERF.md's open
questions), with their entries as it would list them."""

PARKED = {
    "tt_offline8.recognize_b256": {"config": "tt_offline8", "traffic": "recognize_b256",
                                   "chips": 1},
}


def shrink(cfg, traffic):
    data, model = cfg["data"], cfg["model"]
    data.update(feature_dim=16, max_input_length=40, max_target_length=8)
    for part, layers in (("enc", 2), ("dec", 1)):
        model[part].update(n_layer=layers, d_model=64, n_head=2, d_head=32, d_inner=128)
    model["enc"]["max_input_length"], model["dec"]["max_target_length"] = 40, 8
    model["joint"].update(input_size=128, inner_size=64)
    model["vocab_size"] = 40
    traffic.update(batch=3, pool_batches=4)
    traffic["utterances"].update(mean_s=0.6, min_frames=10, chars_per_s=8, max_labels=7)
    if traffic["entry"] == "recognize":
        traffic.update(max_tokens=8, warmup_batches=1, check_utterances=4, check_states=2,
                       check_block=2)
