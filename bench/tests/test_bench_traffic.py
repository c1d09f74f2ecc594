"""The traffic generator: inputs fixed by the seed, the same sizes for
every seed, the trace's calls replayed as often as they were made."""
import collections
import json

import torch

from bench import check, record_calls, spec, trafficgen


def lens(reqs):
    return sorted(len(check.tokens_of(r.prompt)) for r in reqs)


def news(reqs):
    return sorted(r.max_new_tokens for r in reqs)


def _mix(name):
    return spec.load_cell(f"codeqwen.serve.{name}")["traffic"]


def test_serve_requests_fixed_by_seed_and_sized_alike_across_seeds():
    mix = _mix("ops")
    a = trafficgen.serve_requests(mix, 2 ** 31 + 17)
    assert a == trafficgen.serve_requests(mix, 2 ** 31 + 17)
    b = trafficgen.serve_requests(mix, 5)
    assert [r.prompt for r in a] != [r.prompt for r in b]
    # every block holds the same sizes, so any whole blocks do
    n = mix["block"]
    for i in (0, 7, len(a) // n - 1):
        assert lens(a[i * n:(i + 1) * n]) == lens(b[i * n:(i + 1) * n])
        assert news(a[i * n:(i + 1) * n]) == news(b[i * n:(i + 1) * n])
    assert lens(a) == lens(b) and news(a) == news(b)


def test_prompts_have_their_lengths_and_the_operator_form():
    mix = _mix("ops")
    got = trafficgen.serve_requests(mix, 3)
    made = collections.Counter()
    for c in mix["calls"]:
        made[(c["op"], c["prompt"], c["new_tokens"])] += c["count"]
    replayed = collections.Counter((r.op, r.prompt, r.max_new_tokens)
                                   for r in got)
    # every call as often as it was made, less the last partial block
    assert not replayed - made
    assert sum((made - replayed).values()) < mix["block"]
    for r in got:
        assert r.prompt.endswith("\nAnswer:") and "\nInput: " in r.prompt
        assert len(check.tokens_of(r.prompt)) + r.max_new_tokens \
            < mix["max_len"]
        assert 1 <= r.max_new_tokens <= 16


def test_operator_shares_and_median():
    """The fixed order deals the trace evenly: the stretch a window serves
    holds each operator at its share of the whole trace."""
    mix = _mix("ops")
    reqs = trafficgen.serve_requests(mix, 9)
    whole = collections.Counter(r.op for r in reqs)
    head = collections.Counter(r.op for r in reqs[:4096])
    for op, n in whole.items():
        assert abs(head[op] / 4096 - n / len(reqs)) <= 0.02
    assert abs(sorted(lens(reqs[:4096]))[2048]
               - lens(reqs)[len(reqs) // 2]) <= 8


def test_trace_is_the_systems_own_calls(tmp_path):
    """The committed trace is what ``record_calls`` records from the port's
    semantic queries."""
    out = tmp_path / "calls.jsonl"
    record_calls.main(["--rows", "250", "--out", str(out)])
    with open(out) as f:
        got = [json.loads(line) for line in f]
    assert got == _mix("ops")["calls"]
    ops = collections.Counter(c["op"] for c in got)
    assert set(ops) <= {"filter", "map", "rank", "reduce"}


def test_train_tokens_fixed_by_seed_and_step():
    mix = spec._json(spec.ROOT / "bench" / "traffic" / "train_4k.json")
    a = trafficgen.train_tokens(mix, 92416, 2 ** 31 + 5, 3, "cpu")
    assert a.shape == (mix["batch"], mix["seq"])
    assert torch.equal(a, trafficgen.train_tokens(mix, 92416, 2 ** 31 + 5,
                                                  3, "cpu"))
    assert not torch.equal(a, trafficgen.train_tokens(mix, 92416,
                                                      2 ** 31 + 5, 4, "cpu"))
    assert int(a.min()) >= 0 and int(a.max()) < 92416


def test_warmup_covers_every_padded_length():
    mix = _mix("ops")
    pads = set(trafficgen.warmup_lengths(mix, 16))
    for r in trafficgen.serve_requests(mix, 1):
        n = len(check.tokens_of(r.prompt))
        assert -(-n // 16) * 16 in pads
