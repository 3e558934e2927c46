"""Interactive streaming REPL — the examples/interactive.rs capability.

Reads lines from stdin, streams them through a StreamSession, and writes
the audio incrementally (to a WAV file, or raw f32 to stdout for piping
into an audio player: the reference's cpal playback role is filled by
`--raw | aplay`-style piping, or by --play). The counterpart of
grail_tpu/interactive.py on the port's StreamSession; like every entry
point it runs on the card unless --device cpu asks for the plain version.

    python -m grail_tpu_torch.interactive -o live.wav -v plain -l english
"""

from __future__ import annotations

import argparse

import sys

import numpy as np

from .runtime.stream import StreamSession


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="grail-tpu-torch interactive streaming TTS")
    def positive_int(s):
        v = int(s)
        if v < 1:
            raise argparse.ArgumentTypeError("must be >= 1")
        return v

    ap.add_argument("-v", "--voice", default="plain",
                    help="voice preset name or a .json voice file")
    ap.add_argument("-l", "--language", default="english",
                    help="language preset name or a .json language file")
    ap.add_argument("-o", "--output", default="interactive.wav")
    ap.add_argument("--raw", action="store_true",
                    help="write raw float32 samples to stdout instead of a WAV")
    ap.add_argument("--block", type=positive_int, default=4096)
    ap.add_argument("-c", "--contour", action="store_true")
    ap.add_argument("--play", action="store_true",
                    help="play live through the audio device (or a paced "
                         "mock callback sink with underrun counters when "
                         "headless) — the reference's cpal output role")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the stream is synthesized: the CUDA kernel "
                         "on the card (default) or its plain PyTorch "
                         "version on the CPU")
    args = ap.parse_args(argv)

    # same -v/-l surface as cli.py: preset names or .json documents, with
    # the clean error contract (not a raw KeyError traceback)
    voice, language = args.voice, args.language
    try:
        if isinstance(voice, str) and voice.endswith(".json"):
            from .voices.fileformat import load_voice_file

            voice = load_voice_file(voice)
        if isinstance(language, str) and language.endswith(".json"):
            from .languages.fileformat import load_language_file

            language = load_language_file(language)
        session = StreamSession(voice=voice, language=language,
                                block=args.block, contour=args.contour,
                                device=args.device)
    except (KeyError, OSError, ValueError) as e:
        print(f"error: {e.args[0] if e.args else e}", file=sys.stderr)
        return 1
    sr = int(session.sample_rate)

    sink = None
    if args.play:
        from .runtime.playback import open_sink

        sink = open_sink(sr, block=args.block)
        print(f"playback: {sink.mode} sink, block {args.block} "
              f"({sink.period * 1e3:.1f} ms)", file=sys.stderr)

    chunks = []

    def emit(a: np.ndarray):
        if sink is not None:
            sink.write(a)
        if args.raw:
            sys.stdout.buffer.write(a.astype(np.float32).tobytes())
            sys.stdout.buffer.flush()
        else:
            # --play also records: the -o WAV is written like cli.py's
            # (playback AND file), not silently dropped
            chunks.append(a)

    print(f"grail-tpu interactive: voice={args.voice} language={args.language} "
          f"(type text, Ctrl-D to finish)", file=sys.stderr)
    try:
        for line in sys.stdin:
            try:
                session.feed(line.rstrip("\n") + " ", parse_commands=True)
                # flush inside the try: an unterminated command fragment at
                # end-of-line raises here (strict grammar) and must keep
                # the REPL alive just like a bad command
                session.flush()
            except (ValueError, KeyError) as e:
                # bad command ([typo:..], unknown voice/lang, ...) — report
                # and keep the stream alive, like any REPL. NO `continue`:
                # text fed before the error already synthesized score and
                # must still be drained below, or it would be silently
                # missing from the output at EOF
                print(f"error: {e}", file=sys.stderr)
                session._pending_cmd = ""   # line-oriented REPL: drop the
                #                             fragment, the line is done
            # drain everything pending plus a short tail
            n = int(session.pending_seconds * sr) + session.block
            emit(session.read(n))
            if sink is not None:
                sink.end()
    except KeyboardInterrupt:
        pass
    # final drain (Ctrl-C mid-line): fed text is never silently dropped
    n = int(session.pending_seconds * sr)
    if n > 0:
        emit(session.read(n + session.block))
        if sink is not None:
            sink.end()

    if sink is not None:
        sink.drain()
        st = sink.close()
        print(f"playback done: {st['pulls']} pulls, {st['underruns']} "
              f"underruns, worst_late {st['worst_late_ms']} ms",
              file=sys.stderr)
    if not args.raw and chunks:
        from .runtime.wav import save_wav

        audio = np.concatenate(chunks)
        save_wav(args.output, audio, sr)
        print(f"wrote {len(audio) / sr:.2f}s to {args.output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
