"""lz4 command-line tool on the port's codec.

[De]Compress data in the lz4 frame format (the JAX package's ``cli.py``;
lz4_flex lz4_bin/src/main.rs:9-166): `.lz4` extension autodetection, `-d`
force decompress, `-f` overwrite without prompting, `--clean` to delete
originals, `-o` output path, stdin/stdout piping when no file is given, and
a compression-ratio report.

Extensions: `--mode linked`, `--block-size`, `--block-checksums`,
`--content-checksum`, `--legacy` expose the frame options; `--engine device`
streams through the codec on the CUDA card (buffered blocks batched per
device dispatch, decode batches through the ring kernel) instead of the
native host runtime, and fails without a card; decode drains all
concatenated frames.

Usage: python -m lz4_flex_tpu_torch.cli [options] [file]
"""

from __future__ import annotations

import argparse
import os
import sys

from .frame import BlockMode, BlockSize, FrameDecoder, FrameEncoder, FrameInfo

LZ_EXTENSION = ".lz4"
_COPY_CHUNK = 1 << 20


def _build_frame_info(args) -> FrameInfo:
    return FrameInfo(
        block_size=BlockSize[args.block_size],
        block_mode=BlockMode.Linked if args.mode == "linked" else BlockMode.Independent,
        block_checksums=args.block_checksums,
        content_checksum=args.content_checksum,
        legacy_frame=args.legacy,
    )


class _TrackWriteSize:
    """Counts bytes written through to the inner stream."""

    def __init__(self, inner) -> None:
        self.inner = inner
        self.written = 0

    def write(self, b) -> int:
        n = self.inner.write(b)
        n = len(b) if n is None else n
        self.written += n
        return n

    def flush(self) -> None:
        if hasattr(self.inner, "flush"):
            self.inner.flush()


def _copy_compress(src, dst, frame_info: FrameInfo, engine: str = "host",
                   device=None) -> tuple[int, int]:
    """Compress src stream into dst stream; returns (input_size, output_size).

    Both engines stream: "host" drives the native runtime block by block,
    "device" batches buffered blocks through the device encoder
    (FrameEncoder(engine="device") on ``device``: None for the CUDA card)
    without slurping the input."""
    tracker = _TrackWriteSize(dst)
    enc = FrameEncoder(tracker, frame_info, engine=engine, device=device)
    total = 0
    while True:
        chunk = src.read(_COPY_CHUNK)
        if not chunk:
            break
        total += len(chunk)
        enc.write(chunk)
    enc.try_finish()
    return total, tracker.written


def _copy_decompress(src, dst, engine: str = "host", device=None) -> int:
    dec = FrameDecoder(src, engine=engine, device=device)
    total = 0
    while True:
        chunk = dec.read(_COPY_CHUNK)
        if not chunk:
            # Frame boundary or EOF: probe for a concatenated frame.
            if dec.frame_info is None and not dec._probe_next_frame():
                break
            continue
        dst.write(chunk)
        total += len(chunk)
    return total


def _handle_file(args) -> int:
    path = args.input_file
    decompress = path.endswith(LZ_EXTENSION) or args.decompress
    if args.decompress and not path.endswith(LZ_EXTENSION) and args.out is None:
        print("Can't determine an output filename", file=sys.stderr)
        return 1

    if args.out is not None:
        output = args.out
    else:
        if decompress:
            output = path[: -len(LZ_EXTENSION)] if path.endswith(LZ_EXTENSION) else path + ".out"
        else:
            output = path + LZ_EXTENSION
        print(f"{'Decompressed' if decompress else 'Compressed'} filename will be: {output}")
        if not args.force and os.path.exists(output):
            answer = input(f"{output} already exists, do you want to overwrite? (y/N) ")
            if not answer.startswith("y"):
                print("Not overwriting")
                return 0

    if decompress:
        with open(path, "rb") as src, open(output, "wb") as dst:
            _copy_decompress(src, dst, args.engine)
    else:
        with open(path, "rb") as src, open(output, "wb") as dst:
            input_size, output_size = _copy_compress(src, dst, _build_frame_info(args), args.engine)
        pct = output_size * 100.0 / input_size if input_size else 0.0
        print(f"Compressed {input_size} bytes into {output_size} ==> {pct:.2f}%")

    if args.clean:
        os.remove(path)
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="lz4-tpu-torch", description="[De]Compress data in the lz4 format."
    )
    parser.add_argument("input_file", nargs="?", help="file to compress/decompress ('-' for stdin)")
    parser.add_argument("-o", "--out", help="output file to write to (defaults to stdout)")
    parser.add_argument("-d", "--decompress", action="store_true", help="force decompress")
    parser.add_argument("-f", "--force", action="store_true", help="overwrite output files")
    parser.add_argument("--clean", action="store_true", help="delete original files")
    parser.add_argument(
        "--mode", choices=["independent", "linked"], default="independent",
        help="block mode (default: independent)",
    )
    parser.add_argument(
        "--block-size",
        choices=["Auto", "Max64KB", "Max256KB", "Max1MB", "Max4MB", "Max8MB"],
        default="Auto",
        help="maximum uncompressed block size (default: Auto)",
    )
    parser.add_argument("--block-checksums", action="store_true", help="add per-block checksums")
    parser.add_argument("--content-checksum", action="store_true", help="add a content checksum")
    parser.add_argument("--legacy", action="store_true", help="write the legacy frame format")
    parser.add_argument(
        "--engine",
        choices=["host", "device"],
        default="host",
        help="codec engine: 'host' (streaming native runtime) or 'device' "
        "(streaming codec on the CUDA card; fails without one)",
    )
    args = parser.parse_args(argv)

    if args.engine == "device":
        from .ops.ringdecode import resolve_device

        try:
            resolve_device(None)
        except RuntimeError as e:
            print(f"lz4-tpu-torch: --engine device: {e}", file=sys.stderr)
            return 1

    if args.input_file is not None and args.input_file != "-":
        return _handle_file(args)

    # stdin/stdout mode
    src = sys.stdin.buffer
    dst = open(args.out, "wb") if args.out else sys.stdout.buffer
    try:
        if args.decompress:
            _copy_decompress(src, dst, args.engine)
        else:
            _copy_compress(src, dst, _build_frame_info(args), args.engine)
    finally:
        if args.out:
            dst.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
