package paddle

// Reference: go/paddle/predictor.go -- NewPredictor / Run / outputs over
// the C inference ABI.  This binding targets the paddle_tpu_torch C ABI
// (paddle_tpu_torch/inference/csrc/paddle_tpu_capi.h): PT_NewPredictor /
// PT_PredictorRun / PT_GetOutput.  The library is built by
// paddle_tpu_torch.inference.capi.load_capi() into
// build/paddle_tpu_torch_capi/ at the repository root.
//
// cgo pointer discipline: PT_PredictorRun takes arrays of pointers; Go
// pointers may not be stored into C-visible memory, so input buffers and
// the pointer tables are staged in C allocations for the duration of the
// call.

/*
#cgo CFLAGS: -I${SRCDIR}/../../csrc
#cgo LDFLAGS: -L${SRCDIR}/../../../../build/paddle_tpu_torch_capi -lpaddle_tpu_torch_capi
#include <stdlib.h>
#include <string.h>
#include "paddle_tpu_capi.h"
*/
import "C"

import (
	"errors"
	"fmt"
	"os"
	"runtime"
	"sync"
	"unsafe"
)

const deviceEnv = "PADDLE_TPU_TORCH_CAPI_DEVICE"

// envMu serializes the device switch around PT_NewPredictor.
var envMu sync.Mutex

// Predictor wraps a loaded model.  Run is not safe for concurrent use
// on one Predictor (the C ABI stashes outputs per predictor).
type Predictor struct {
	ptr *C.PT_Predictor
}

// NewPredictor loads the jit.save'd model named by config.ModelDir(), on
// the card unless config.DisableGpu() asked for the CPU.
func NewPredictor(config *Config) (*Predictor, error) {
	cs := C.CString(config.ModelDir())
	defer C.free(unsafe.Pointer(cs))
	envMu.Lock()
	prev, had := os.LookupEnv(deviceEnv)
	if config.UseGpu() {
		os.Setenv(deviceEnv, "gpu")
	} else {
		os.Setenv(deviceEnv, "cpu")
	}
	p := C.PT_NewPredictor(cs)
	if had {
		os.Setenv(deviceEnv, prev)
	} else {
		os.Unsetenv(deviceEnv)
	}
	envMu.Unlock()
	if p == nil {
		return nil, fmt.Errorf("paddle: loading %q failed (see stderr)",
			config.ModelDir())
	}
	pred := &Predictor{ptr: p}
	runtime.SetFinalizer(pred, func(pr *Predictor) { pr.Delete() })
	return pred, nil
}

// Delete releases the predictor (reference: DeletePredictor).
func (p *Predictor) Delete() {
	if p.ptr != nil {
		C.PT_DeletePredictor(p.ptr)
		p.ptr = nil
	}
}

// Run executes the model on float32 inputs and returns all outputs.
func (p *Predictor) Run(inputs []*Tensor) ([]*Tensor, error) {
	if p.ptr == nil {
		return nil, errors.New("paddle: predictor deleted")
	}
	n := len(inputs)
	if n == 0 {
		return nil, errors.New("paddle: no inputs")
	}

	// stage inputs in C memory (see the cgo note above)
	dataPtrs := C.malloc(C.size_t(n) * C.size_t(unsafe.Sizeof(uintptr(0))))
	shapePtrs := C.malloc(C.size_t(n) * C.size_t(unsafe.Sizeof(uintptr(0))))
	ndims := C.malloc(C.size_t(n) * C.size_t(unsafe.Sizeof(C.int32_t(0))))
	defer C.free(dataPtrs)
	defer C.free(shapePtrs)
	defer C.free(ndims)
	dataTab := (*[1 << 28]unsafe.Pointer)(dataPtrs)[:n:n]
	shapeTab := (*[1 << 28]unsafe.Pointer)(shapePtrs)[:n:n]
	ndimTab := (*[1 << 28]C.int32_t)(ndims)[:n:n]

	for i, t := range inputs {
		nb := C.size_t(len(t.Data)) * 4
		buf := C.malloc(nb + 4)
		defer C.free(buf)
		if len(t.Data) > 0 {
			C.memcpy(buf, unsafe.Pointer(&t.Data[0]), nb)
		}
		sb := C.malloc(C.size_t(len(t.Shape))*8 + 8)
		defer C.free(sb)
		if len(t.Shape) > 0 {
			C.memcpy(sb, unsafe.Pointer(&t.Shape[0]),
				C.size_t(len(t.Shape))*8)
		}
		dataTab[i] = buf
		shapeTab[i] = sb
		ndimTab[i] = C.int32_t(len(t.Shape))
	}

	nOut := C.PT_PredictorRun(p.ptr,
		(**C.float)(dataPtrs), (**C.int64_t)(shapePtrs),
		(*C.int32_t)(ndims), C.int32_t(n))
	if nOut < 0 {
		return nil, errors.New("paddle: PT_PredictorRun failed")
	}

	outs := make([]*Tensor, int(nOut))
	for i := range outs {
		var raw C.PT_Output
		if C.PT_GetOutput(p.ptr, C.int32_t(i), &raw) != 0 {
			C.PT_FreeOutput(&raw)
			return nil, fmt.Errorf("paddle: PT_GetOutput(%d) failed", i)
		}
		shape := make([]int64, int(raw.ndim))
		if raw.ndim > 0 {
			src := (*[1 << 28]C.int64_t)(unsafe.Pointer(raw.shape))
			for d := range shape {
				shape[d] = int64(src[d])
			}
		}
		data := make([]float32, int(raw.numel))
		if raw.numel > 0 {
			src := (*[1 << 28]C.float)(unsafe.Pointer(raw.data))
			for j := range data {
				data[j] = float32(src[j])
			}
		}
		C.PT_FreeOutput(&raw)
		outs[i] = &Tensor{Data: data, Shape: shape}
	}
	return outs, nil
}
