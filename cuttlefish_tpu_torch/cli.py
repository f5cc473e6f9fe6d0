"""Command-line tool of the port: a copy of ``cuttlefish_tpu/cli.py``.

The flag surface of the reference `cuttlefish` CLI: `tool/CommandLine.cpp`
(flags, symbolic resize sizes, case-insensitive keywords, validation) and
`tool/main.cpp` (processing order, exit codes 1=args, 2=load,
3=convert/save).  The block encoders run on the CUDA card
(``run(argv, device=None)``; tests pass ``device="cpu"``, which runs their
plain PyTorch versions).  `-j/--jobs` is accepted for compatibility and
ignored: the encode is one batch of blocks on the card, split over the
device mesh where one is active (``cuttlefish_tpu_torch.parallel``).
"""

from __future__ import annotations

import os
import sys

from cuttlefish_tpu_torch.formats import (
    Alpha,
    ColorSpace,
    CubeFace,
    Dimension,
    FileType,
    ImageIndex,
    MipReplacement,
    Quality,
    SaveResult,
    TextureFormat,
    TextureType,
    file_type_for_name,
    has_native_srgb,
    is_format_valid,
    max_mipmap_levels,
)
from cuttlefish_tpu_torch.image import Channel, Image, ImageFormat, NormalOptions, ResizeFilter, RotateAngle
from cuttlefish_tpu_torch.texture import CustomMipImage, Texture

# Symbolic resize sizes (CommandLine.h:41-58).
ORIGINAL = -1
_SYMBOLIC_SIZES = {
    "nextpo2": -2, "nearestpo2": -3, "width": -4, "width-nextpo2": -5,
    "width-nearestpo2": -6, "height": -7, "height-nextpo2": -8,
    "height-nearestpo2": -9, "min": -10, "min-nextpo2": -11,
    "min-nearestpo2": -12, "max": -13, "max-nextpo2": -14,
    "max-nearestpo2": -15,
}

_FILTERS = {
    "box": ResizeFilter.Box,
    "linear": ResizeFilter.Linear,
    "cubic": ResizeFilter.Cubic,
    "catmull-rom": ResizeFilter.CatmullRom,
    "b-spline": ResizeFilter.BSpline,
}

_FACES = {
    "+x": CubeFace.PosX, "-x": CubeFace.NegX,
    "+y": CubeFace.PosY, "-y": CubeFace.NegY,
    "+z": CubeFace.PosZ, "-z": CubeFace.NegZ,
}

_TYPES = {
    "unorm": TextureType.UNorm, "snorm": TextureType.SNorm,
    "uint": TextureType.UInt, "int": TextureType.Int,
    "ufloat": TextureType.UFloat, "float": TextureType.Float,
}

_ALPHAS = {
    "none": Alpha.Null, "standard": Alpha.Standard,
    "pre-multiplied": Alpha.PreMultiplied, "encoded": Alpha.Encoded,
}

_QUALITIES = {
    "lowest": Quality.Lowest, "low": Quality.Low, "normal": Quality.Normal,
    "high": Quality.High, "highest": Quality.Highest,
}

_FILE_FORMATS = {
    "dds": FileType.DDS,
    "ktx": FileType.KTX,
    "ktx2": FileType.KTX2,
    "pvr": FileType.PVR,
}

_SWIZZLE = {
    "r": Channel.Red, "g": Channel.Green, "b": Channel.Blue,
    "a": Channel.Alpha, "x": Channel.Null,
}

_FORMATS = {f.name.lower(): f for f in TextureFormat if f is not TextureFormat.Unknown}

IMAGE, ARRAY, CUBE, CUBE_ARRAY = range(4)
_LIST_TYPES = {"image": IMAGE, "array": ARRAY, "cube": CUBE, "cube-array": CUBE_ARRAY}

HELP = """Usage: cuttlefish [options]

General options:
  -h, --help     display this help message
  -j, --jobs [n] the number of jobs to convert with (accepted for
                 compatibility; this build encodes on the CUDA card)
  -q, --quiet    suppress all non-error output
  -v, --verbose  verbose output

Input files (at least one required, cannot mix different types):
  -i, --input file               input image for a standard texture
  -a, --array [n] file           input image for an array or 3D texture
  -c, --cube face file           input image for a cube map face
                                   (face: +x, -x, +y, -y, +z, -z)
  -C, --cube-array n face file   input image for a cube map array
  -I, --input-list type file     file listing image paths
                                   (type: image, array, cube, cube-array)

Image processing:
  -r, --resize w h [filter]      resize images; w/h may be a number or:
                                   nextpo2, nearestpo2, width, height, min,
                                   max (optionally with -nextpo2 /
                                   -nearestpo2 suffixes)
                                 filter: box, linear, cubic, catmull-rom,
                                 b-spline
  -m, --mipmap [levels] [filter] generate mipmaps
  -M, --custom-mip level [depth] [face] [once|continue] file
                                 provide a custom mip image
      --custom-mip-list file     file listing custom mip entries
      --flipx / --flipy          flip images
      --rotate degrees           rotate by a multiple of 90 degrees
  -n, --normalmap [wrap|wrapx|wrapy] [height]
                                 generate a normal map from a height field
  -g, --grayscale                convert to grayscale
  -s, --swizzle rgbax            swizzle channels (r, g, b, a, or x for none)
      --srgb                     treat input as sRGB
      --pre-multiply             pre-multiply alpha

Output:
  -d, --dimension 1|2|3          texture dimension
  -f, --format name              texture format (see list in docs)
  -t, --type type                unorm, snorm, uint, int, ufloat, float
      --alpha mode               none, standard, pre-multiplied, encoded
  -Q, --quality q                lowest, low, normal, high, highest
  -o, --output file              output texture path
      --file-format dds|ktx|ktx2|pvr
                                 container (deduced from extension if absent)
      --create-dir               create the output directory if needed
      --device-mips              build the mipmaps on the CUDA card and
                                 encode every level in one batch
                                 (extension; block formats, no custom mips)
      --supercompression none|zstd|zlib
                                 KTX2 supercompression scheme, applied per
                                 mip level (KTX2 output only)
      --texture-info file        print a DDS/KTX/KTX2/PVR container's
                                 metadata and exit (extension)
"""


class Args:
    def __init__(self):
        self.jobs = 1
        self.log = "normal"  # normal | quiet | verbose
        self.image_type = IMAGE
        # Slot list mirroring the reference's std::vector<std::string>
        # (CommandLine.cpp:859-976): arrays index by element, cube maps by
        # CubeFace enum value, cube arrays by index*6+face; unset slots are
        # None ("not all images were provided" at validate).
        self.images: list = []
        self.width = ORIGINAL
        self.height = ORIGINAL
        self.resize_filter = ResizeFilter.CatmullRom
        self.mip_levels = 0
        self.mip_filter = ResizeFilter.CatmullRom
        self.custom_mips: dict[ImageIndex, CustomMipImage] = {}
        self.flip_x = False
        self.flip_y = False
        self.rotate = None
        self.normal_map = False
        self.normal_options = NormalOptions.Default
        self.normal_height = 1.0
        self.grayscale = False
        self.swizzle = None
        self.image_color_space = ColorSpace.Linear
        self.texture_color_space = ColorSpace.Linear
        self.pre_multiply = False
        self.dimension = Dimension.Dim2D
        self.fmt = TextureFormat.Unknown
        self.type = TextureType.UNorm
        self.type_set = False  # explicit -t seen (CommandLine.cpp:818,1301)
        self.alpha = None
        self.quality = Quality.Normal
        self.output = ""
        self.file_type = FileType.Auto
        self.create_dir = False
        self.device_mips = False
        self.supercompression = "none"
        self.texture_info = None  # --texture-info: print + exit


def _err(msg: str) -> None:
    print(f"error: {msg}", file=sys.stderr)


def _parse_custom_mip_entry(line: str):
    """One custom-mip list line: level [depth] [face] [once|continue] file.

    Mirrors `readCustomMipList` (CommandLine.cpp:553-620): optional tokens
    are consumed greedily and the file name is the REST of the line, so
    paths with spaces work (the reference fixture has "array 0.png").  The
    default replacement is Continue, matching the reference.
    """

    def next_token(s: str):
        s = s.lstrip("\t\v\f ")
        j = 0
        while j < len(s) and s[j] not in "\t\v\f ":
            j += 1
        return s[:j], s[j:]

    tok, rest = next_token(line)
    if not tok.isdigit():
        _err(f"invalid mip level {tok}")
        return None
    level = int(tok)
    depth = 0
    face = CubeFace.PosX
    repl = MipReplacement.Continue
    tok, rest2 = next_token(rest)
    if tok.isdigit():
        depth = int(tok)
        rest = rest2
        tok, rest2 = next_token(rest)
    if tok.lower() in _FACES:
        face = _FACES[tok.lower()]
        rest = rest2
        tok, rest2 = next_token(rest)
    if tok.lower() in ("once", "continue"):
        repl = (
            MipReplacement.Once if tok.lower() == "once"
            else MipReplacement.Continue
        )
        rest = rest2
    path = rest.strip("\t\v\f ")
    if not path:
        _err(
            f"no file provided for custom mip level {level}, depth {depth}"
        )
        return None
    idx = ImageIndex(cube_face=face, mip_level=level, depth=depth)
    return idx, CustomMipImage(path, repl)


def parse(argv: list[str]) -> Args | None:
    """Parse argv (without program name); None on error or after --help."""
    args = Args()
    if not argv:
        print(HELP)
        return None

    def need(i, n, flag):
        if i + n >= len(argv):
            _err(f"command {flag} requires {n} argument{'s' if n > 1 else ''}")
            return False
        return True

    mix_error = "cannot mix different types of image inputs"

    i = 0
    ok = True
    while i < len(argv) and ok:
        a = argv[i]
        if a in ("-h", "--help"):
            print(HELP)
            return None
        elif a in ("-j", "--jobs"):
            if i + 1 < len(argv) and argv[i + 1].isdigit():
                args.jobs = int(argv[i + 1])
                i += 1
            else:
                args.jobs = 0  # all cores / whole mesh
        elif a in ("-q", "--quiet"):
            args.log = "quiet"
        elif a in ("-v", "--verbose"):
            args.log = "verbose"
        elif a in ("-i", "--input"):
            # Any prior input (including another -i) is a mix error
            # (CommandLine.cpp:841-857).
            if args.images:
                _err(mix_error)
                ok = False
            else:
                ok = need(i, 1, a)
                if ok:
                    args.image_type = IMAGE
                    args.images.append(argv[i + 1])
                    i += 1
        elif a in ("-a", "--array"):
            if args.images and args.image_type != ARRAY:
                _err(mix_error)
                ok = False
            else:
                ok = need(i, 1, a)
            if ok:
                args.image_type = ARRAY
                if i + 2 < len(argv) and argv[i + 1].isdigit():
                    index = int(argv[i + 1])
                    path = argv[i + 2]
                    i += 2
                else:
                    index = len(args.images)
                    path = argv[i + 1]
                    i += 1
                if index >= len(args.images):
                    args.images.extend(
                        [None] * (index + 1 - len(args.images)))
                if args.images[index] is not None:
                    _err(f"image for index {index} already provided")
                    ok = False
                else:
                    args.images[index] = path
        elif a in ("-c", "--cube"):
            if args.images and args.image_type != CUBE:
                _err(mix_error)
                ok = False
            else:
                ok = need(i, 2, a)
            if ok:
                if not args.images:
                    args.images = [None] * 6
                args.image_type = CUBE
                face = _FACES.get(argv[i + 1].lower())
                if face is None:
                    _err(f"unknown cube face '{argv[i + 1]}'")
                    ok = False
                elif args.images[int(face)] is not None:
                    _err(f"image for face {argv[i + 1]} already provided")
                    ok = False
                else:
                    args.images[int(face)] = argv[i + 2]
                    i += 2
        elif a in ("-C", "--cube-array"):
            if args.images and args.image_type != CUBE_ARRAY:
                _err(mix_error)
                ok = False
            else:
                ok = need(i, 3, a)
            if ok:
                args.image_type = CUBE_ARRAY
                if not argv[i + 1].isdigit():
                    _err(f"invalid index {argv[i + 1]}")
                    ok = False
                else:
                    cube_index = int(argv[i + 1])
                    face = _FACES.get(argv[i + 2].lower())
                    if face is None:
                        _err(f"unknown cube face '{argv[i + 2]}'")
                        ok = False
                    else:
                        slot = cube_index * 6 + int(face)
                        need_len = (cube_index + 1) * 6
                        if need_len > len(args.images):
                            args.images.extend(
                                [None] * (need_len - len(args.images)))
                        if args.images[slot] is not None:
                            _err(
                                f"image for index {cube_index} and face "
                                f"{argv[i + 2]} already provided"
                            )
                            ok = False
                        else:
                            args.images[slot] = argv[i + 3]
                            i += 3
        elif a in ("-I", "--input-list"):
            if args.images:
                _err(mix_error)
                ok = False
            else:
                ok = need(i, 2, a)
            if ok:
                ltype = _LIST_TYPES.get(argv[i + 1].lower())
                if ltype is None:
                    _err(f"unknown image type {argv[i + 1]}")
                    ok = False
                else:
                    args.image_type = ltype
                    try:
                        with open(argv[i + 2]) as f:
                            paths = [ln.strip() for ln in f if ln.strip()]
                    except OSError:
                        _err(
                            f"couldn't open image list file '{argv[i + 2]}'"
                        )
                        ok = False
                    else:
                        # Raw line order; cube lists map positionally to
                        # CubeFace enum order (main.cpp:352-366).
                        args.images.extend(paths)
                        i += 2
        elif a in ("-r", "--resize"):
            ok = need(i, 2, a)
            if ok:
                def parse_size(s):
                    sl = s.lower()
                    if sl in _SYMBOLIC_SIZES:
                        return _SYMBOLIC_SIZES[sl]
                    if s.isdigit() and int(s) > 0:
                        return int(s)
                    return None

                w = parse_size(argv[i + 1])
                h = parse_size(argv[i + 2])
                if w is None or h is None:
                    _err("invalid resize size")
                    ok = False
                else:
                    args.width, args.height = w, h
                    i += 2
                    if i + 1 < len(argv) and argv[i + 1].lower() in _FILTERS:
                        args.resize_filter = _FILTERS[argv[i + 1].lower()]
                        i += 1
        elif a in ("-m", "--mipmap"):
            args.mip_levels = -1  # all levels
            if i + 1 < len(argv) and argv[i + 1].isdigit():
                args.mip_levels = int(argv[i + 1])
                i += 1
            if i + 1 < len(argv) and argv[i + 1].lower() in _FILTERS:
                args.mip_filter = _FILTERS[argv[i + 1].lower()]
                i += 1
        elif a in ("-M", "--custom-mip"):
            ok = need(i, 2, a)
            if ok:
                if not argv[i + 1].isdigit():
                    _err("custom mip level must be a number")
                    ok = False
                else:
                    level = int(argv[i + 1])
                    i += 1
                    depth = 0
                    face = CubeFace.PosX
                    # Default replacement is Continue (CommandLine.cpp:1076).
                    repl = MipReplacement.Continue
                    if i + 1 < len(argv) and argv[i + 1].isdigit():
                        depth = int(argv[i + 1])
                        i += 1
                    if i + 1 < len(argv) and argv[i + 1].lower() in _FACES:
                        face = _FACES[argv[i + 1].lower()]
                        i += 1
                    if i + 1 < len(argv) and argv[i + 1].lower() in ("once", "continue"):
                        repl = (
                            MipReplacement.Once
                            if argv[i + 1].lower() == "once"
                            else MipReplacement.Continue
                        )
                        i += 1
                    if i + 1 >= len(argv):
                        _err("custom mip requires an image path")
                        ok = False
                    else:
                        idx = ImageIndex(
                            cube_face=face, mip_level=level, depth=depth
                        )
                        if idx in args.custom_mips:
                            _err(
                                f"custom mip for level {level}, depth "
                                f"{depth} already provided"
                            )
                            ok = False
                        else:
                            args.custom_mips[idx] = CustomMipImage(
                                argv[i + 1], repl
                            )
                            i += 1
        elif a == "--custom-mip-list":
            ok = need(i, 1, a)
            if ok:
                try:
                    with open(argv[i + 1]) as f:
                        lines = [ln.rstrip("\r\n") for ln in f if ln.strip()]
                except OSError:
                    _err(f"couldn't open custom mip file '{argv[i + 1]}'")
                    ok = False
                else:
                    for line in lines:
                        entry = _parse_custom_mip_entry(line)
                        if entry is None:
                            ok = False
                            break
                        idx, cm = entry
                        if idx in args.custom_mips:
                            _err(
                                f"custom mip for level {idx.mip_level}, "
                                f"depth {idx.depth} already provided"
                            )
                            ok = False
                            break
                        args.custom_mips[idx] = cm
                    i += 1
        elif a == "--flipx":
            args.flip_x = True
        elif a == "--flipy":
            args.flip_y = True
        elif a == "--rotate":
            ok = need(i, 1, a)
            if ok:
                try:
                    angle = int(argv[i + 1])
                except ValueError:
                    angle = 1
                if angle % 90 != 0:
                    _err("rotate angle must be a multiple of 90 degrees")
                    ok = False
                else:
                    quarter = (angle // 90) % 4
                    args.rotate = {
                        0: None,
                        1: RotateAngle.CW90,
                        2: RotateAngle.CW180,
                        3: RotateAngle.CW270,
                    }[quarter]
                    i += 1
        elif a in ("-n", "--normalmap"):
            args.normal_map = True
            if i + 1 < len(argv):
                nl = argv[i + 1].lower()
                if nl == "wrap":
                    args.normal_options |= NormalOptions.WrapX | NormalOptions.WrapY
                    i += 1
                elif nl == "wrapx":
                    args.normal_options |= NormalOptions.WrapX
                    i += 1
                elif nl == "wrapy":
                    args.normal_options |= NormalOptions.WrapY
                    i += 1
            if i + 1 < len(argv):
                try:
                    args.normal_height = float(argv[i + 1])
                    i += 1
                except ValueError:
                    pass
        elif a in ("-g", "--grayscale"):
            args.grayscale = True
        elif a in ("-s", "--swizzle"):
            ok = need(i, 1, a)
            if ok:
                sw = argv[i + 1].lower()
                if len(sw) != 4 or any(c not in _SWIZZLE for c in sw):
                    _err(f"invalid swizzle '{argv[i + 1]}'")
                    ok = False
                else:
                    args.swizzle = tuple(_SWIZZLE[c] for c in sw)
                    i += 1
        elif a == "--srgb":
            args.image_color_space = ColorSpace.sRGB
            args.texture_color_space = ColorSpace.sRGB
        elif a == "--pre-multiply":
            args.pre_multiply = True
        elif a in ("-d", "--dimension"):
            ok = need(i, 1, a)
            if ok:
                dims = {"1": Dimension.Dim1D, "2": Dimension.Dim2D, "3": Dimension.Dim3D}
                d = dims.get(argv[i + 1])
                if d is None:
                    _err(f"invalid dimension '{argv[i + 1]}'")
                    ok = False
                else:
                    args.dimension = d
                    i += 1
        elif a in ("-f", "--format"):
            ok = need(i, 1, a)
            if ok:
                fmt = _FORMATS.get(argv[i + 1].lower())
                if fmt is None:
                    _err(f"unknown format '{argv[i + 1]}'")
                    ok = False
                else:
                    args.fmt = fmt
                    i += 1
                    # Unique default types (CommandLine.cpp:1300-1309):
                    # UFloat-only formats default to UFloat unless -t was
                    # given explicitly.
                    if not args.type_set and fmt in (
                        TextureFormat.B10G11R11_UFloat,
                        TextureFormat.E5B9G9R9_UFloat,
                        TextureFormat.BC6H,
                    ):
                        args.type = TextureType.UFloat
        elif a in ("-t", "--type"):
            ok = need(i, 1, a)
            if ok:
                t = _TYPES.get(argv[i + 1].lower())
                if t is None:
                    _err(f"unknown type '{argv[i + 1]}'")
                    ok = False
                else:
                    args.type = t
                    args.type_set = True
                    i += 1
        elif a == "--alpha":
            ok = need(i, 1, a)
            if ok:
                al_mode = _ALPHAS.get(argv[i + 1].lower())
                if al_mode is None:
                    _err(f"unknown alpha mode '{argv[i + 1]}'")
                    ok = False
                else:
                    args.alpha = al_mode
                    i += 1
        elif a in ("-Q", "--quality"):
            ok = need(i, 1, a)
            if ok:
                q = _QUALITIES.get(argv[i + 1].lower())
                if q is None:
                    _err(f"unknown quality '{argv[i + 1]}'")
                    ok = False
                else:
                    args.quality = q
                    i += 1
        elif a in ("-o", "--output"):
            ok = need(i, 1, a)
            if ok:
                if args.output:
                    _err("output file already provided")
                    ok = False
                else:
                    args.output = argv[i + 1]
                    i += 1
        elif a == "--file-format":
            ok = need(i, 1, a)
            if ok:
                ft = _FILE_FORMATS.get(argv[i + 1].lower())
                if ft is None:
                    _err(f"unknown file format '{argv[i + 1]}'")
                    ok = False
                else:
                    args.file_type = ft
                    i += 1
        elif a == "--create-dir":
            args.create_dir = True
        elif a == "--device-mips":
            args.device_mips = True
        elif a == "--supercompression":
            ok = need(i, 1, a)
            if ok:
                sc = argv[i + 1].lower()
                if sc not in ("none", "zlib", "zstd"):
                    _err(f"unknown supercompression '{argv[i + 1]}'")
                    ok = False
                else:
                    args.supercompression = sc
                    i += 1
        elif a == "--texture-info":
            ok = need(i, 1, a)
            if ok:
                args.texture_info = argv[i + 1]
                i += 1
        else:
            _err(f"unknown option '{a}'")
            ok = False
        i += 1

    if not ok:
        return None
    if not validate(args):
        return None
    return args


def validate(args: Args) -> bool:
    """Post-parse validation (CommandLine.cpp:624-793)."""
    if args.texture_info is not None:
        return True  # info mode needs no pipeline arguments
    if not args.images:
        _err("an input image must be provided")
        return False
    if args.image_type == IMAGE and len(args.images) != 1:
        _err("only 1 input image may be provided for a standard texture")
        return False
    if args.image_type in (CUBE, CUBE_ARRAY):
        if args.image_type == CUBE and len(args.images) != 6:
            _err("6 images must be provided for a cubemap texture")
            return False
        if args.image_type == CUBE_ARRAY and len(args.images) % 6 != 0:
            _err(
                "a multiple of 6 images must be provided for a cubemap "
                "texture"
            )
            return False
        if args.dimension is not Dimension.Dim2D:
            _err("cubemap texture must have a dimension of 2")
            return False
        args.dimension = Dimension.Cube
    for path in args.images:
        if not path:
            _err("not all images were provided")
            return False
    if args.fmt is TextureFormat.Unknown:
        _err("texture file format cannot be determined")
        return False
    if not args.output:
        _err("output file must be provided")
        return False
    if args.file_type is FileType.Auto:
        args.file_type = file_type_for_name(args.output)
        if args.file_type is FileType.Auto:
            _err(f"cannot deduce file type for '{args.output}'")
            return False
    if not is_format_valid(args.fmt, args.type, args.file_type):
        _err(
            f"file format {args.file_type.name} doesn't support format "
            f"{args.fmt.name} with type {args.type.name}"
        )
        return False
    if args.texture_color_space is ColorSpace.sRGB and not has_native_srgb(
        args.fmt, args.type
    ):
        args.texture_color_space = ColorSpace.Linear
    # Custom mips require mipmap generation beyond the base level
    # (reference checks mipLevels <= 1; our 0 means "-m not given").
    if args.custom_mips and args.mip_levels in (0, 1):
        _err("cannot specify custom mip images without generating mipmaps")
        return False
    depth_count = len(args.images)
    level_depth_counts: dict[int, int] = {}
    for idx in args.custom_mips:
        if idx.mip_level == 0:
            _err("cannot provide custom mip for level 0")
            return False
        this_depth = depth_count
        if args.dimension is Dimension.Dim3D:
            this_depth = max(depth_count >> idx.mip_level, 1)
            level_depth_counts[idx.mip_level] = (
                level_depth_counts.get(idx.mip_level, 0) + 1
            )
        if idx.depth >= this_depth:
            _err(
                f"custom mip depth {idx.depth} out of range for level "
                f"{idx.mip_level}"
            )
            return False
    # 3D textures must have either no depths or all depths per level.
    for level, count in level_depth_counts.items():
        this_depth = max(depth_count >> level, 1)
        if count != this_depth:
            _err(f"must provide custom mips for all depths in level {level}")
            return False
    if args.alpha is None:
        args.alpha = Alpha.PreMultiplied if args.pre_multiply else Alpha.Standard
    return True


# ---------------------------------------------------------------------------
# Pipeline (tool/main.cpp)
# ---------------------------------------------------------------------------


def _next_po2(x: int) -> int:
    return 1 << (x - 1).bit_length()


def _nearest_po2(x: int) -> int:
    up = _next_po2(x)
    down = max(1, up >> 1)
    return up if up - x <= x - down else down


def _get_dimension(base: int, width: int, height: int, size: int) -> int:
    if size >= 0:
        return size
    table = {
        ORIGINAL: base,
        -2: _next_po2(base), -3: _nearest_po2(base),
        -4: width, -5: _next_po2(width), -6: _nearest_po2(width),
        -7: height, -8: _next_po2(height), -9: _nearest_po2(height),
        -10: min(width, height), -11: _next_po2(min(width, height)),
        -12: _nearest_po2(min(width, height)),
        -13: max(width, height), -14: _next_po2(max(width, height)),
        -15: _nearest_po2(max(width, height)),
    }
    return table[size]


def _is_signed(t: TextureType) -> bool:
    return t in (TextureType.SNorm, TextureType.Int, TextureType.Float)


def load_and_process_image(args: Args, path: str, size_box: list, mip_level: int = 0):
    """Load + process one input (main.cpp:147-277).  Returns Image or None."""
    verbose = args.log == "verbose"
    if verbose:
        print(f"loading image '{path}'")
    img = Image(path, args.image_color_space)
    if not img:
        _err(f"couldn't load image '{path}'")
        return None

    if size_box[0] is None:
        size_box[0] = _get_dimension(img.width, img.width, img.height, args.width)
        size_box[1] = _get_dimension(img.height, img.width, img.height, args.height)
    width, height = size_box

    orig_format = img.format
    if img.format is not ImageFormat.RGBAF:
        img = img.convert(ImageFormat.RGBAF)
    if args.texture_color_space is not args.image_color_space:
        img.change_color_space(args.texture_color_space)

    this_w = max(width >> mip_level, 1)
    this_h = max(height >> mip_level, 1)
    nw, nh = (width, height) if args.normal_map else (this_w, this_h)
    if nw != img.width or nh != img.height:
        if verbose:
            print(f"resizing image '{path}' to {nw} x {nh}")
        img = img.resize(nw, nh, args.resize_filter)
    if args.rotate is not None:
        img = img.rotate(args.rotate)
    if args.grayscale:
        img.grayscale()
    if args.normal_map:
        options = args.normal_options
        if _is_signed(args.type):
            options |= NormalOptions.KeepSign
        img = img.create_normal_map(options, args.normal_height)
        if (nw, nh) != (this_w, this_h):
            img = img.resize(this_w, this_h, args.resize_filter)
        orig_format = img.format
    if args.flip_x:
        img.flip_horizontal()
    if args.flip_y:
        img.flip_vertical()
    if args.swizzle is not None:
        img.swizzle(*args.swizzle)
    if args.pre_multiply:
        img.pre_multiply_alpha()
    img = Texture.adjust_image_value_range(img, args.type, orig_format)
    return img


def _texture_info(path: str) -> int:
    """--texture-info: parse a DDS/KTX/KTX2/PVR container and print its
    metadata (extension beyond the reference CLI; exit 2 on load errors,
    the load-stage exit-code domain)."""
    from cuttlefish_tpu_torch.containers.load import LoadError, load_texture

    try:
        tex = load_texture(path)
    except (OSError, ValueError, NotImplementedError) as e:
        # ValueError covers LoadError and malformed-stream struct errors;
        # NotImplementedError covers decode-scope limits on foreign files.
        _err(f"cannot load '{path}': {e}")
        return 2
    dims = f"{tex.width()}x{tex.height()}"
    if tex.dimension is Dimension.Dim3D:
        dims += f"x{tex.depth()}"
    print(f"file:       {path}")
    print(f"dimension:  {tex.dimension.name}")
    print(f"size:       {dims}")
    if tex.is_array:
        print(f"layers:     {tex.depth()}")
    print(f"faces:      {tex.faces}")
    print(f"mip levels: {tex.mip_levels}")
    print(f"format:     {tex.format.name}")
    print(f"type:       {tex.type.name}")
    print(f"colorspace: {tex.color_space.name}")
    print(f"alpha:      {tex.alpha_type.name}")
    total = sum(
        tex.data_size(CubeFace(f), m, d)
        for m in range(tex.mip_levels)
        for d in range(max(tex.depth(m), 1) if tex.dimension is Dimension.Dim3D
                       else max(tex.depth(), 1))
        for f in range(tex.faces)
    )
    print(f"data bytes: {total}")
    return 0


def run(argv: list[str], device=None) -> int:
    """Run the CLI on ``argv`` (without the program name) and return its
    exit code.  ``device`` is the texture's torch device: ``None`` is the
    CUDA card, as in ``Texture``."""
    args = parse(argv)
    if args is None:
        return 1

    if args.texture_info is not None:
        return _texture_info(args.texture_info)

    verbose = args.log == "verbose"
    size_box = [None, None]

    # Load all inputs (main.cpp:279-292, exit code 2 domain).
    loaded = []
    for path in args.images:
        img = load_and_process_image(args, path, size_box)
        if img is None:
            return 2
        loaded.append(img)

    width, height = size_box
    dim = args.dimension

    # Custom-mip range checks need the final size, so they live here in the
    # load stage like the reference (main.cpp:290-308, exit code 2).
    if args.custom_mips:
        requested = 0xFFFFFFFF if args.mip_levels < 0 else args.mip_levels
        mip_count = min(
            requested,
            max_mipmap_levels(dim, width, height, len(args.images)),
        )
        for idx in args.custom_mips:
            if idx.mip_level >= mip_count:
                _err(f"level {idx.mip_level} for custom mip out of range")
                return 2
            if (
                idx.cube_face is not CubeFace.PosX
                and dim is not Dimension.Cube
            ):
                _err("custom mip cube face used for non-cubemap texture")
                return 2

    if args.image_type == ARRAY and dim is not Dimension.Dim3D:
        depth = len(loaded)
    elif args.image_type == CUBE_ARRAY:
        depth = len(loaded) // 6
    elif args.image_type == ARRAY:
        depth = len(loaded)  # 3D: slice count
    else:
        depth = 0

    tex = Texture(
        dim,
        width,
        height,
        depth=depth,
        mip_levels=1,
        color_space=args.texture_color_space,
        device=device,
    )
    if not tex.is_valid:
        _err("couldn't create texture")
        return 3

    for n, img in enumerate(loaded):
        if args.image_type == CUBE:
            ok = tex.set_image(img, face=CubeFace(n))
        elif args.image_type == CUBE_ARRAY:
            ok = tex.set_image(img, face=CubeFace(n % 6), depth=n // 6)
        elif args.image_type == ARRAY:
            ok = tex.set_image(img, depth=n)
        else:
            ok = tex.set_image(img)
        if not ok:
            _err(f"couldn't set image '{args.images[n]}'")
            return 3

    if args.mip_levels != 0 and args.device_mips and not args.custom_mips:
        # Fused device pipeline: mip chain + encode in one device dispatch
        # (falls through to the host path when the format/shape doesn't
        # qualify — convert_with_mips returns False without side effects).
        levels = 0xFFFFFFFF if args.mip_levels < 0 else args.mip_levels
        if verbose:
            print("generating mipmaps on device (fused)")
        try:
            if tex.convert_with_mips(
                args.fmt,
                args.type,
                quality=args.quality,
                alpha_type=args.alpha,
                mip_levels=levels,
                filter=args.mip_filter,
            ):
                if verbose:
                    print(f"saving '{args.output}'")
                result = tex.save(args.output, args.file_type, args.supercompression)
                if result is SaveResult.WriteError and args.create_dir:
                    parent = os.path.dirname(args.output)
                    if parent:
                        os.makedirs(parent, exist_ok=True)
                        result = tex.save(args.output, args.file_type, args.supercompression)
                if result is not SaveResult.Success:
                    _err(f"couldn't save '{args.output}': {result.name}")
                    return 3
                if args.log == "normal":
                    print(f"converted '{args.output}'")
                return 0
        except (NotImplementedError, ValueError) as exc:
            _err(str(exc))
            return 3
        if verbose:
            print("fused path unavailable; falling back to host mipmaps")

    if args.mip_levels != 0:
        levels = 0xFFFFFFFF if args.mip_levels < 0 else args.mip_levels
        custom = {}
        for idx, cm in args.custom_mips.items():
            cimg = load_and_process_image(
                args, cm.image, size_box, mip_level=idx.mip_level
            )
            if cimg is None:
                return 2
            custom[idx] = CustomMipImage(cimg, cm.replacement)
        if verbose:
            print("generating mipmaps")
        if not tex.generate_mipmaps(
            filter=args.mip_filter,
            mip_levels=levels,
            custom_mip_images=custom or None,
        ):
            _err("couldn't generate mipmaps")
            return 3

    if verbose:
        print(f"converting to {args.fmt.name} ({args.type.name})")
    try:
        ok = tex.convert(
            args.fmt,
            args.type,
            quality=args.quality,
            alpha_type=args.alpha,
        )
    except (NotImplementedError, ValueError) as exc:
        _err(str(exc))
        return 3
    if not ok:
        _err("couldn't convert texture")
        return 3

    if verbose:
        print(f"saving '{args.output}'")
    result = tex.save(args.output, args.file_type, args.supercompression)
    if result is SaveResult.WriteError and args.create_dir:
        parent = os.path.dirname(args.output)
        if parent:
            os.makedirs(parent, exist_ok=True)
            result = tex.save(args.output, args.file_type, args.supercompression)
    if result is not SaveResult.Success:
        _err(f"couldn't save '{args.output}': {result.name}")
        return 3

    if args.log == "normal":
        print(f"converted '{args.output}'")
    elif verbose:
        print(f"done: '{args.output}'")
    return 0


def main() -> None:
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
