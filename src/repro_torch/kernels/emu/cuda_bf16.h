// Host stand-in for <cuda_bf16.h> under CPU emulation.
#pragma once
#include "cuda_emu.h"
