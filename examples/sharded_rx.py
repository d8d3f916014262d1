"""Multi-device RX chain demo: the full FIR -> decimate -> FFT -> demod
chain sharded over a (channel, time) mesh with halo exchange, verified
bit-identical to the single-device path.

On a multi-GPU host the mesh spans the cards (and hosts, with
``parallel.mesh.init_distributed``; ``python chip_smoke.py --four-cards``
runs it on four); here it runs on 8 virtual CPU devices so the sharding
machinery is demonstrable anywhere.

Run: python examples/sharded_rx.py
"""

import _bootstrap  # noqa: F401  (offline bare-clone path setup)
import os

import numpy as np


def main():
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")

    from aether_primitives_tpu.models import RxChain, RxChainConfig
    from aether_primitives_tpu.parallel import mesh as mesh_mod

    devs = jax.devices()
    print(f"{len(devs)} devices: {devs[0].platform}")
    mesh = mesh_mod.make_mesh({"channel": 2, "time": len(devs) // 2})
    print(f"mesh: {dict(mesh.shape)}")

    cfg = RxChainConfig(fft_len=256, decimation=4)
    chain = RxChain(cfg)

    rng = np.random.default_rng(0)
    n_per_dev = 4 * 256 * 2
    n = (len(devs) // 2) * n_per_dev
    x = (rng.normal(size=(2, n)) + 1j * rng.normal(size=(2, n))).astype(np.complex64)

    bits_sharded = np.asarray(chain.sharded_step_2d(x, mesh))
    bits_single = np.asarray(chain.step(x))
    agree = (bits_sharded == bits_single).mean()
    print(
        f"sharded chain: {bits_sharded.shape[0]} channels x "
        f"{bits_sharded.shape[1]} bits; agreement vs single-device: {agree:.1%}"
    )
    assert agree == 1.0


if __name__ == "__main__":
    main()
