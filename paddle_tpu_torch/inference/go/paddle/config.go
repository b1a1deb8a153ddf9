// Package paddle: Go inference binding over the paddle_tpu_torch C ABI.
//
// Reference: go/paddle/config.go (AnalysisConfig over paddle_inference_c).
// The model is a jit.save'd path prefix; the predictor serves on the
// current CUDA device unless DisableGpu asks for the CPU.
package paddle

// Config mirrors the reference AnalysisConfig surface that remains
// meaningful here: the model's location and its device.
type Config struct {
	modelPrefix string
	cpu         bool
}

// NewConfig returns an empty config (reference: NewAnalysisConfig).
func NewConfig() *Config { return &Config{} }

// AnalysisConfig is the reference-compatible alias.
type AnalysisConfig = Config

// NewAnalysisConfig matches the reference constructor name.
func NewAnalysisConfig() *AnalysisConfig { return NewConfig() }

// SetModel points at a jit.save'd model. The reference takes
// (model_file, params_file); here one prefix addresses both files, and
// a non-empty params argument is ignored.
func (c *Config) SetModel(modelPrefix string, params string) {
	c.modelPrefix = modelPrefix
}

// ModelDir returns the configured model prefix.
func (c *Config) ModelDir() string { return c.modelPrefix }

// ProgFile returns the model prefix (the program file is prefix.pdmodel).
func (c *Config) ProgFile() string { return c.modelPrefix }

// ParamsFile returns the model prefix (the weights are prefix.pdiparams).
func (c *Config) ParamsFile() string { return c.modelPrefix }

// EnableUseGpu serves on the current CUDA device (the default); the
// memory pool size and device id arguments of the reference are ignored.
func (c *Config) EnableUseGpu(memoryPoolMb uint64, deviceID int32) {
	c.cpu = false
}

// DisableGpu serves on the CPU: NewPredictor sets
// PADDLE_TPU_TORCH_CAPI_DEVICE=cpu while it creates the predictor.
func (c *Config) DisableGpu() { c.cpu = true }

// UseGpu reports whether the predictor will serve on the card.
func (c *Config) UseGpu() bool { return !c.cpu }

// SwitchIrOptim is a truthful no-op: the saved program runs as exported.
func (c *Config) SwitchIrOptim(bool) {}

// IrOptim reports false: no graph pass runs at load.
func (c *Config) IrOptim() bool { return false }
