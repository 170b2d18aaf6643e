"""The byte offsets of a C struct of a kernel source, as g++ lays it out,
for the tests that hold a ``ctypes.Structure`` mirror to it."""

import os
import re
import subprocess

from render_engine_tpu_torch import kernels


def field_names(src_path, struct):
    """The field names of ``struct`` in the source, in order."""
    src = open(src_path).read()
    body = re.search(r"struct %s \{(.*?)\n\};" % struct, src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        parts = re.sub(r"\bconst\b", "", decl).replace("*", " ").split(",")
        first = parts[0].split()
        for part in [first[-1]] + [p.strip() for p in parts[1:]]:
            names.append(part.split("[")[0].strip())
    return names, body


def offsets(src_path, struct):
    """``(names, offsets, size)``: g++'s offsetof of every field of
    ``struct`` and its sizeof."""
    names, body = field_names(src_path, struct)
    prog = ("#include <cstddef>\n#include <cstdio>\nstruct %s {" % struct
            + body + "\n};\nint main() {\n"
            + "".join(f'  printf("%zu\\n", offsetof({struct}, {n}));\n'
                      for n in names)
            + f'  printf("%zu\\n", sizeof({struct}));\n}}\n')
    build = os.path.join(os.path.dirname(kernels.__file__), "_build")
    os.makedirs(build, exist_ok=True)
    cpp = os.path.join(build, f"{struct.lower()}_{os.getpid()}.cpp")
    exe = cpp[:-4]
    try:
        with open(cpp, "w") as f:
            f.write(prog)
        subprocess.run(["g++", "-std=c++17", "-o", exe, cpp], check=True,
                       capture_output=True, timeout=120)
        out = subprocess.run([exe], check=True, capture_output=True,
                             text=True, timeout=60).stdout.split()
    finally:
        for p in (cpp, exe):
            if os.path.exists(p):
                os.remove(p)
    out = [int(x) for x in out]
    return names, out[:-1], out[-1]
