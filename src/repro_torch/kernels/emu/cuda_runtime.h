// Host stand-in for <cuda_runtime.h> under CPU emulation.
#pragma once
#include "cuda_emu.h"
