"""Command-line interface (the counterpart of grail_tpu/cli.py).

Flag surface mirrors the reference CLI (examples/cli.rs:73-124):
  -h/--help, -V/--version, -v/--voice, -o/--output, -l/--language,
  -r/--resample, -i/--input, -s/--silent
with one deliberate upgrade: -v/-l/-r are actually wired into the pipeline
(the reference parses but ignores them — examples/cli.rs:84,175-184 hardcode
the generic voice/language). Prints the reference's timing line
("X seconds of audio, generated in Y microseconds", examples/cli.rs:186-193).
--device {cuda,cpu} picks where the synthesizer runs: the CUDA kernels on
the card (the default; without a card it is an error, not a fallback) or
their plain PyTorch versions on the CPU.

-o writes a WAV; --play plays back through an audio device or a paced mock
sink; -s is accepted for compatibility.
"""

from __future__ import annotations

import sys
import time

from . import __version__
from .api import synthesize
from .languages import language_names
from .runtime.wav import save_wav
from .voices import voice_names


def _has_argument(args, short, long):
    return short in args or long in args


def _find_argument(args, short, long):
    for i in range(len(args) - 1):
        if args[i] in (short, long):
            return args[i + 1]
    return None


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)

    if _has_argument(args, "-h", "--help") or not args:
        print("Grail-TPU on PyTorch and CUDA, a speech synthesizer")
        print("The last argument is interpreted as text to be spoken")
        print("So 'grail -v bob hello' will say 'hello'. -v is to set the voice, bob in this case")
        print("Flags:")
        print("-v or --voice is to set the voice")
        print("-o or --output to set the output file path")
        print("-l or --language sets the language ruleset")
        print("-r or --resample to change the sample rate")
        print("-i or --input to read from a file")
        print("-s or --silent to not play back any sound")
        print("-c or --contour to enable the intonation contour")
        print("--play to play back through the audio device (or a paced")
        print("       mock sink with underrun counters when headless)")
        print("--device cuda or cpu: the card (default) or the CPU")
        print("-V or --version to display the version")
        print("Voices:")
        for n in voice_names():
            print(f"  {n}")
        print("Languages:")
        for n in language_names():
            print(f"  {n}")
        return 0

    if _has_argument(args, "-V", "--version"):
        print(f"Grail-TPU version {__version__}")
        return 0

    voice = _find_argument(args, "-v", "--voice") or "generic"
    language = _find_argument(args, "-l", "--language") or "generic"
    # declarative data files (the reference's voice-file roadmap item,
    # README.md:17): -v/-l accept a path to a JSON voice/language document
    if isinstance(voice, str) and voice.endswith(".json"):
        from .voices.fileformat import load_voice_file

        try:
            voice = load_voice_file(voice)
        except (OSError, ValueError, KeyError) as e:
            print(f"error: could not load voice file {voice!r}: {e}")
            return 1
    if isinstance(language, str) and language.endswith(".json"):
        from .languages.fileformat import load_language_file

        try:
            language = load_language_file(language)
        except (OSError, ValueError, KeyError) as e:
            print(f"error: could not load language file {language!r}: {e}")
            return 1
    output_file = _find_argument(args, "-o", "--output") or ""
    resample = _find_argument(args, "-r", "--resample")
    input_file = _find_argument(args, "-i", "--input")
    contour = _has_argument(args, "-c", "--contour")
    device = _find_argument(args, "--device", "--device") or "cuda"
    if device not in ("cuda", "cpu"):
        print(f"error: --device expects cuda or cpu, got {device!r}")
        return 1

    if input_file:
        try:
            with open(input_file) as f:
                to_say = f.read()
        except OSError:
            print(f'Could not open file "{input_file}"')
            return 1
    else:
        to_say = args[-1]

    if resample:
        try:
            sample_rate = float(resample)
        except ValueError:
            print(f"error: -r expects a sample rate in Hz, got {resample!r}")
            return 1
        if not sample_rate > 0:
            print(f"error: -r sample rate must be positive, got {resample}")
            return 1
    else:
        # voice-native: a .json voice authored at another rate must not be
        # silently resampled to the default (only -r requests a resample)
        try:
            from .api import _resolve_voice

            sample_rate = float(_resolve_voice(voice).sample_rate)
        except KeyError as e:
            print(f"error: {e.args[0]}")
            return 1

    print(f'"{to_say}"')
    print(f" -- {getattr(voice, 'name', voice)}")

    start = time.perf_counter()
    try:
        audio = synthesize(to_say, voice=voice, language=language,
                           sample_rate=sample_rate, contour=contour,
                           device=device).cpu().numpy()
    except KeyError as e:
        print(f"error: {e.args[0]}")
        return 1
    except ValueError as e:
        # e.g. resample rate below the voice's jitter bound
        print(f"error: {e}")
        return 1
    duration_us = int((time.perf_counter() - start) * 1e6)

    print(f"{len(audio) / sample_rate:.2f} seconds of audio, "
          f"generated in {duration_us} microseconds")

    if output_file:
        print(f"Writing generated sound to {output_file}")
        save_wav(output_file, audio, int(sample_rate))

    # live playback (the reference's cpal path, examples/cli.rs:205-272):
    # a real sounddevice stream when hardware exists, else a paced mock
    # sink with the same pull contract + underrun counters (headless)
    if "--play" in args and \
            not _has_argument(args, "-s", "--silent"):
        from .runtime.playback import open_sink

        sink = open_sink(sample_rate, block=1024)
        sink.write(audio)
        sink.end()
        sink.drain(timeout=len(audio) / sample_rate + 5.0)
        st = sink.close()
        print(f"played {len(audio) / sample_rate:.2f}s via {sink.mode} sink "
              f"({st['underruns']} underruns)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
