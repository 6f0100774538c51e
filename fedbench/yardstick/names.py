"""How kernels are known in a device trace (frozen from chip_smoke.py:393
`KERNEL_SYMBOLS` and :438 `PRODUCT_MARKS`)."""

#: the symbol each of the port's hand-written kernels carries in a trace
PORT_KERNELS = {"flash": "flash_fwd_kernel", "wkv6": "wkv6_fwd_kernel",
                "mamba": "mamba_scan_fwd_kernel", "objective": "fedsem_objective_kernel"}
#: what marks a matrix product's kernel (cuBLAS and CUTLASS names)
PRODUCT_MARKS = ("gemm", "xmma", "nvjet", "cutlass")


def is_port_kernel(name: str) -> bool:
    return any(sym in name for sym in PORT_KERNELS.values())


def is_product(name: str) -> bool:
    low = name.lower()
    return not is_port_kernel(name) and any(m in low for m in PRODUCT_MARKS)


def device_seconds(kernels: dict, match) -> tuple[int, float]:
    """(launches, device seconds) of a trace summary's kernels whose name
    ``match`` accepts."""
    hits = [v for name, v in kernels.items() if match(name)]
    return sum(c for c, _ in hits), sum(s for _, s in hits)
