"""The port's light client vs the JAX package's, on the CPU.

Chains come from tests/helpers.make_light_chain (four validators of power
10; one replaced at every height, so that skipping verification has to
bisect, or all four, so that no trust carries over) and are carried
across with cometbft_tpu_torch.convert. Headers and validator sets must
hash to the same bytes. Then the same scenario runs through
cometbft_tpu.light and through cometbft_tpu_torch.light (device="cpu",
the kernels' plain versions, in both kernel flavors, with the pubkey
cache on and off), and both must end the same way: the same trace of
verified heights and the same provider fetches, or the same error class
with the same fields. Scenarios: adjacent, non-adjacent with bisection,
backwards, an expired trusted header, a wrong next_validators_hash, an
untrusted validator set and a tampered commit signature.
"""

import dataclasses

import pytest
import torch

import helpers
from cometbft_tpu import light as jlight
from cometbft_tpu_torch import convert
from cometbft_tpu_torch import light as tlight
from cometbft_tpu_torch.crypto import batch as tbatch
from cometbft_tpu_torch.ops import cuda_verify
from cometbft_tpu_torch.ops import verify as tverify
from cometbft_tpu_torch.types import block as tblock

SECOND = 1_000_000_000
PERIOD = 3 * 3600 * SECOND
CHAIN_ID = helpers.CHAIN_ID
# (flavor, pubkey cache): K4's plain version (X1 building its tables),
# and K1's; K3's and K2's are held in test_torch_kernel8 and
# test_torch_verify
MODES = [("8", True), ("4", False)]


@pytest.fixture(autouse=True)
def _device_route(monkeypatch):
    """These commits are smaller than the port's host/device cut, which
    would send them to the host tier (held in test_torch_host_batch.py and
    test_torch_coalesce.py): pin the cut to 2 so they take the device
    route, the kernels' plain versions, that this file holds."""
    monkeypatch.setattr(tbatch, "HOST_BATCH_THRESHOLD", 2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: intra-op threads only add overhead."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tampered(chain, height, idx):
    """``chain`` with one signature byte of ``height``'s commit flipped."""
    lb = chain[height]
    commit = lb.signed_header.commit
    sigs = list(commit.signatures)
    cs = sigs[idx]
    sig = bytes([cs.signature[0] ^ 1]) + cs.signature[1:]
    sigs[idx] = dataclasses.replace(cs, signature=sig)
    out = dict(chain)
    out[height] = dataclasses.replace(
        lb,
        signed_header=dataclasses.replace(
            lb.signed_header,
            commit=dataclasses.replace(commit, signatures=sigs),
        ),
    )
    return out


@pytest.fixture(scope="module")
def chains():
    """name -> (reference chain, port chain)."""
    rotating = helpers.make_light_chain(6, rotate=1)
    fixed = helpers.make_light_chain(3)
    swapped = helpers.make_light_chain(6, rotate=4)
    mixed = {1: fixed[1], 2: swapped[2]}  # 2's set is not 1's next set
    ref = {
        "rotating": rotating,
        "mixed": mixed,
        "swapped": swapped,
        "tampered": _tampered(rotating, 2, 1),
    }
    return {k: (v, convert.light_chain_from(v)) for k, v in ref.items()}


def _provider(base):
    class DictProvider(base):
        def __init__(self, blocks):
            self.blocks = blocks
            self.fetched = []

        def chain_id(self):
            return CHAIN_ID

        def light_block(self, height):
            self.fetched.append(height)
            if height == 0:
                height = max(self.blocks)
            return self.blocks[height]

    return DictProvider


JProvider = _provider(jlight.Provider)
TProvider = _provider(tlight.Provider)


def _describe(e):
    """An error as (class name, fields), its reason described in turn."""
    if dataclasses.is_dataclass(e):
        return (type(e).__name__, tuple(
            (f.name, _describe(getattr(e, f.name)))
            for f in dataclasses.fields(e)
        ))
    if isinstance(e, Exception):
        return (type(e).__name__, str(e))
    return e


def _run(pkg, provider_cls, blocks, trust_height, target, now_ns,
         commit_verifier=None):
    """The outcome of one light-client scenario: ("ok", trace heights,
    stored heights, fetches) or ("error", description, fetches)."""
    provider = provider_cls(blocks)
    kwargs = {}
    if commit_verifier is not None:
        kwargs["commit_verifier"] = commit_verifier
    try:
        client = pkg.Client(
            chain_id=CHAIN_ID,
            trust_options=pkg.TrustOptions(
                PERIOD, trust_height, blocks[trust_height].hash()
            ),
            primary=provider,
            trusted_store=pkg.MemStore(),
            **kwargs,
        )
        lb = client.verify_light_block_at_height(target, now_ns)
    except pkg.LightClientError as e:
        return ("error", _describe(e), provider.fetched)
    except Exception as e:  # a commit check's own error, not wrapped
        return ("error", _describe(e), provider.fetched)
    assert lb.height == target
    stored = [
        h for h in sorted(blocks) if _has(client.trusted_store, h)
    ]
    return ("ok", [b.height for b in client.latest_trace], stored,
            provider.fetched)


def _has(store, height):
    try:
        store.light_block(height)
        return True
    except Exception:
        return False


# name: (chain, trusted height, target height, now: seconds after target)
SCENARIOS = {
    "adjacent": ("rotating", 1, 2, 1),
    "bisection": ("rotating", 1, 4, 1),
    "backwards": ("rotating", 4, 2, 1),
    "expired": ("rotating", 1, 6, PERIOD // SECOND),
    "wrong_next_validators_hash": ("mixed", 1, 2, 1),
    "tampered_signature": ("tampered", 1, 2, 1),
}


@pytest.fixture(scope="module")
def reference_outcomes(chains):
    out = {}
    for name, (chain, trusted, target, after) in SCENARIOS.items():
        blocks = chains[chain][0]
        now = blocks[max(target, trusted)].time_ns + after * SECOND
        out[name] = _run(jlight, JProvider, blocks, trusted, target, now)
    return out


def test_hashes_identical_after_convert(chains):
    for ref, port in chains.values():
        assert sorted(ref) == sorted(port)
        for h, lb in ref.items():
            t = port[h]
            assert t.hash() == lb.hash() and t.hash() is not None
            assert t.validator_set.hash() == lb.validator_set.hash()
            assert (t.signed_header.commit.hash()
                    == lb.signed_header.commit.hash())
            t.validate_basic(CHAIN_ID)
    # a header without a validators hash has no hash, as in the reference
    hdr = chains["rotating"][1][1].signed_header.header
    assert dataclasses.replace(hdr, validators_hash=b"").hash() is None
    assert isinstance(hdr, tblock.Header)


def test_reference_outcomes_are_the_expected_ones(reference_outcomes):
    """The scenarios do what their names say (on the reference)."""
    out = reference_outcomes
    assert out["adjacent"][:2] == ("ok", [1, 2])
    # 4 keeps one of 1's four validators: pivot to 3, which keeps two
    assert out["bisection"][:2] == ("ok", [1, 3, 4])
    assert out["backwards"][0] == "ok" and out["backwards"][2] == [2, 3, 4]
    assert out["expired"][1][0] == "VerificationFailedError"
    assert "OldHeaderExpiredError" in str(out["expired"][1])
    assert "expected old header next validators" in str(
        out["wrong_next_validators_hash"][1])
    assert "wrong signature (#1)" in str(out["tampered_signature"][1])


@pytest.mark.parametrize("flavor,cached", MODES)
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_light_outcome_matches_reference(chains, reference_outcomes, name,
                                         flavor, cached, monkeypatch):
    """Uncached: COMETBFT_TPU_PUBKEY_CACHE=0 and no cache given."""
    if not cached:
        monkeypatch.setenv("COMETBFT_TPU_PUBKEY_CACHE", "0")
    chain, trusted, target, after = SCENARIOS[name]
    blocks = chains[chain][1]
    now = blocks[max(target, trusted)].time_ns + after * SECOND
    cache = tverify.PubkeyTableCache(device="cpu", capacity=32) \
        if cached else None
    cv = tlight.CommitVerifier(device="cpu", flavor=flavor,
                               pubkey_cache=cache)
    cuda_verify.reset_launches()
    got = _run(tlight, TProvider, blocks, trusted, target, now, cv)
    assert got == reference_outcomes[name]
    assert not any(cuda_verify.LAUNCHES.values())  # CPU: plain versions
    if cached:
        assert cache.builds >= 1


def test_untrusted_validator_set_matches_reference(chains):
    """All four validators replaced: verify_non_adjacent finds no trusted
    power in the new commit, in both packages alike."""
    ref, port = chains["swapped"]
    now = ref[5].time_ns + SECOND
    outcomes = []
    for pkg, blocks, kw in (
        (jlight, ref, {}),
        (tlight, port, {"commit_verifier": tlight.CommitVerifier(
            device="cpu", flavor="8")}),
    ):
        with pytest.raises(pkg.NewValSetCantBeTrustedError) as err:
            pkg.verify_non_adjacent(
                blocks[1].signed_header, blocks[1].validator_set,
                blocks[5].signed_header, blocks[5].validator_set,
                PERIOD, now, **kw,
            )
        outcomes.append(_describe(err.value))
    assert outcomes[0] == outcomes[1]
    assert outcomes[1][1][0][1] == (
        "NotEnoughVotingPowerError", (("got", 0), ("needed", 13)))


def test_witness_header_comparison_matches_reference(chains):
    """A witness that serves another header at the height raises
    ConflictingHeadersError naming it, in both packages; witnesses that
    agree pass."""
    ref, port = chains["rotating"]
    other_ref, other_port = chains["swapped"]
    outcomes = []
    for pkg, prov, blocks, other, kw in (
        (jlight, JProvider, ref, other_ref, {}),
        (tlight, TProvider, port, other_port, {"commit_verifier":
         tlight.CommitVerifier(device="cpu", flavor="8")}),
    ):
        client = pkg.Client(
            chain_id=CHAIN_ID,
            trust_options=pkg.TrustOptions(PERIOD, 1, blocks[1].hash()),
            primary=prov(blocks),
            witnesses=[prov(blocks)],
            trusted_store=pkg.MemStore(),
            **kw,
        )
        client.compare_first_header_with_witnesses(blocks[3].signed_header)
        client.witnesses.append(prov(other))
        with pytest.raises(pkg.ConflictingHeadersError) as err:
            client.compare_first_header_with_witnesses(
                blocks[3].signed_header)
        outcomes.append((err.value.witness_index, err.value.block.hash(),
                         [w.fetched for w in client.witnesses]))
    assert outcomes[0] == outcomes[1]
    assert outcomes[1][0] == 1 and outcomes[1][1] == other_ref[3].hash()
